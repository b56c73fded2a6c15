"""PreComp in the benchmark: the configuration ``uniform1m_precomp`` and
its cell ``uniform1m.precomp`` resolve to their files, a whole CPU run at
a tiny size is correct, the q = 1-built control fails its law, and the
three new readers give the numbers their docstrings define, or None (and
no exception) where the port has nothing to read, as before it traced
PreComp.
"""
import builtins
import json
import math
import types

import pytest

from harness import cells, entries, runner

CELL = "uniform1m.precomp"
SEED = 2**31 + 1801
NEW = ("precomp_build_s", "precomp_dispatch_ms_per_step", "precomp_walk_roofline")


def tiny(nodes):
    cell = cells.resolve(CELL)
    cell.config["graph"]["params"]["num_nodes"] = nodes
    return cell


def test_the_cell_resolves_to_precomp_on_uniform1m_s_graph():
    cell = cells.resolve(CELL)
    cfg = cell.config
    base = json.loads((cells.BENCH_DIR / "configs" / "uniform1m.json").read_text())
    assert cfg["graph"] == base["graph"] and cfg["assumed"].items() >= base["assumed"].items()
    assert (cfg["mode"], cfg["p"], cfg["q"]) == ("PreComp", 0.5, 2.0)
    assert (cfg["num_walks"], cfg["walk_length"]) == (10, 80) and cfg["reduced"] == []
    assert cfg["source"] == "https://doi.org/10.1093/bioinformatics/btab202"
    assert {m.name for m in cell.end_to_end} == {"walk_steps_per_s", "setup_s"}
    assert set(NEW) <= {m.name for m in cell.per_layer}
    assert cell.limits == {"walk_faults": 0, "start_faults": 0, "law_z": 9.0}
    assert cell.traffic["entry"] == "walks" and cell.chips == 1


@pytest.fixture(scope="module")
def run():
    from pecanpy_tpu_torch.utils import trace

    trace.reset()
    cell = tiny(1500)
    result, diag = runner.run_cell(cell, SEED, 0.01, True, "cpu", 0.0)
    return cell, result, diag


def test_a_cpu_run_is_correct_and_reads_the_port_s_records(run):
    from pecanpy_tpu_torch import pecanpy

    cell, result, diag = run
    assert result["correct"] and result["metrics"] == {}  # a CPU run measures nothing
    numbers = {k: v["value"] for k, v in diag["cpu_numbers"].items()}
    assert numbers["precomp_build_s"] > 0 and math.isfinite(numbers["precomp_build_s"])
    assert numbers["precomp_dispatch_ms_per_step"] > 0
    assert "precomp_walk_roofline" not in numbers  # no profile on the CPU
    assert diag["readings"]["law_z"] < cell.limits["law_z"]
    assert pecanpy.PreComp.__name__ == cell.config["mode"]


def test_the_q1_built_control_fails_the_law(monkeypatch):
    """The control: the same instance's table built again at q = 1, its
    walks judged by the configuration's law (q = 2)."""
    call = entries.WalksEntry.call

    def control_call(self, seed):
        if self.mode.q != 1.0:
            self.mode.q = 1.0
            self.mode.preprocess_transition_probs()
        return call(self, seed)

    monkeypatch.setattr(entries.WalksEntry, "call", control_call)
    result, diag = runner.run_cell(tiny(6000), SEED, 0.05, False, "cpu", 0.0)
    assert not result["correct"]
    assert diag["readings"]["law_z"] > cells.resolve(CELL).limits["law_z"], diag["readings"]


def _ctx(cell, n_calls, profile=None, num_nodes=1000):
    return dict(cell=cell, config=cell.config, traffic=cell.traffic, calls=[1.0] * n_calls,
                profile=profile, mode=types.SimpleNamespace(num_nodes=num_nodes))


def test_build_s_reads_the_newest_precomp_job():
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)
    reader = cell.metric_reader("precomp_build_s")
    trace.reset()
    assert reader.read(_ctx(cell, 1)) is None
    trace.job("pecanpy.precomp")(lambda: None)()
    trace.job("pecanpy.walks")(lambda: None)()
    rec = trace.last_job("pecanpy.precomp")
    assert reader.read(_ctx(cell, 1)) == 1e-9 * rec.wall_ns


@pytest.mark.parametrize("chunks,steps", [(3, 79), (1, 5)])
def test_dispatch_reads_chunk_time_less_waits_over_steps(chunks, steps):
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)

    @trace.job("pecanpy.walks")
    def call():
        for _ in range(chunks):
            with trace.span("pecanpy.walk.chunk"):
                with trace.sync("pecanpy.walk.start_upload"):
                    pass
                for _ in range(steps):
                    trace.count("walk.precomp_steps")

    call()
    call()
    recs = trace.jobs()[-2:]
    total = sum(r.span("pecanpy.walk.chunk").total_ns for r in recs)
    wait = sum(r.span("pecanpy.walk.chunk").wait_ns for r in recs)
    value = cell.metric_reader("precomp_dispatch_ms_per_step").read(_ctx(cell, 2))
    assert value == pytest.approx(1e-6 * (total - wait) / (2 * chunks * steps))


def test_dispatch_gives_none_without_precomp_steps():
    """The parent's records: chunks, and no PreComp step counter."""
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)

    @trace.job("pecanpy.walks")
    def call():
        with trace.span("pecanpy.walk.chunk"):
            pass

    call()
    assert cell.metric_reader("precomp_dispatch_ms_per_step").read(_ctx(cell, 1)) is None


def test_roofline_reads_least_bytes_over_busy_time():
    cell = cells.resolve(CELL)
    reader = cell.metric_reader("precomp_walk_roofline")
    walks, length = 1000 * 10, 80
    least = walks * (length - 1) * 64 + walks * (length + 1) * 4
    assert reader.least_bytes(walks, length) == least
    value = reader.read(_ctx(cell, 1, profile={"busy_s": 0.5}))
    assert value == pytest.approx(100.0 * least / 3.35e12 / 0.5)
    assert reader.read(_ctx(cell, 1)) is None
    assert reader.read(_ctx(cell, 1, profile={"busy_s": 0.0})) is None


def test_span_readers_give_none_without_the_registry(monkeypatch):
    cell = cells.resolve(CELL)
    real_import = builtins.__import__

    def no_trace(name, *args, **kwargs):
        if name.startswith("pecanpy_tpu_torch.utils") and "trace" in str(args[2:3]):
            raise ImportError("no registry")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    for metric in ("precomp_build_s", "precomp_dispatch_ms_per_step"):
        assert cell.metric_reader(metric).read(_ctx(cell, 1)) is None, metric
