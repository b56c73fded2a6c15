"""Every cell resolves by name to its files; the manifest keeps to the
benchmark's contract; a new cell is new files only."""
import json
import re
import shutil
from pathlib import Path

import pytest

from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def manifest():
    return json.loads(cells.manifest_path().read_text())


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"][1] == "portbench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in m["end_to_end"] + m["per_layer"])) == len(
        m["end_to_end"]) + len(m["per_layer"])
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in m["workloads"])
    assert len(json.dumps(m)) < 64 * 1024
    for x in m["configs"] + m["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for c in m["configs"]:
        assert c["file"].startswith("portbench/") and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    assert callable(cell.graph_generator().generate)
    assert cell.traffic["entry"] in ("embed", "walks")
    e2e = [m.name for m in cell.end_to_end]
    assert "setup_s" in e2e and cell.traffic["rate_metric"] in e2e and len(e2e) == 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m.moves in e2e
        assert callable(cell.metric_reader(m.name).read)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    cfg = cell.config
    assert set(cfg["reduced"]) <= set(cfg["source_values"])


def test_config_files_are_the_manifest_s():
    for c in manifest()["configs"]:
        cfg = json.loads((cells.BENCH_DIR.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_new_cell_is_files_only(tmp_path):
    """A throwaway configuration, traffic mix, generator, metric and cell
    added as new files in a copy run through the harness; no file that was
    there changes."""
    root = tmp_path / "repo"
    shutil.copytree(cells.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    m = manifest()
    bench = root / "portbench"
    cfg = json.loads((bench / "configs" / "uniform1m.json").read_text())
    cfg.update(name="ring", graph={"generator": "ring", "params": {"num_nodes": 600}})
    (bench / "configs" / "ring.json").write_text(json.dumps(cfg))
    (bench / "graphs" / "ring.py").write_text(
        "import numpy as np\n"
        "def generate(seed, num_nodes, device=\"cpu\"):\n"
        "    n = num_nodes\n"
        "    nbr = np.stack([(np.arange(n) - 1) % n, (np.arange(n) + 1) % n], 1)\n"
        "    nbr.sort(1)\n"
        "    return (np.arange(n + 1) * 2, nbr.reshape(-1).astype(np.int64),\n"
        "            np.ones(2 * n, np.float32))\n")
    (bench / "traffic" / "walks_short.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "walks.json").read_text()), name="walks_short")))
    (bench / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['calls']))\n")
    (bench / "limits" / "ring.walks_short.json").write_text(
        json.dumps({"walk_faults": 0, "start_faults": 0, "law_z": 6.0}))
    m["configs"].append(dict(m["configs"][0], name="ring", file="portbench/configs/ring.json"))
    m["workloads"].append(dict(name="ring.walks_short", config="ring", traffic="walks_short",
                               chips=1, why="a ring"))
    m["per_layer"].append(dict(name="calls_in_window", unit="calls", better="higher",
                               source="host_clock", layer="device", moves="walk_steps_per_s",
                               workloads=["ring.walks_short"]))
    for e in m["end_to_end"]:
        if e["name"] == "walk_steps_per_s":
            e["workloads"].append("ring.walks_short")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = cells.resolve("ring.walks_short", bench_dir=bench)
    assert [x.name for x in cell.per_layer][-1] == "calls_in_window"
    from harness import runner

    result, diag = runner.run_cell(cell, 7, 0.1, True, "cpu", 0.0)
    assert result["correct"] and diag["cpu_numbers"]["calls_in_window"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before
    assert cells.resolve("uniform1m.embed", bench_dir=bench).config["name"] == "uniform1m"
