"""Resolve a cell of ``BENCHMARK.json`` by name into its files.

Everything that belongs to one configuration, traffic mix, graph
generator or per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the graph generator and its parameters, the
  mode, p and q, the job's sizes, ``source``, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the entry (``embed`` or ``walks``) the
  window drives, its warm-up and its check's sample sizes;
* ``graphs/<generator>.py``: ``generate(seed, device=..., **params)`` -> CSR triple;
* ``metrics/<metric>.py``: ``read(ctx)`` -> a number or None;
* ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell.

A later cell, mix, generator or metric is a new file and a new entry in
``BENCHMARK.json``; no file here needs an edit for it.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: Path

    def graph_generator(self):
        return load_module(self.bench_dir / "graphs" / f"{self.config['graph']['generator']}.py")

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py")


def load_module(path: Path):
    """Import a file of the benchmark by path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    with open(path) as f:
        return json.load(f)


def manifest_path(bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir.parent / "BENCHMARK.json"


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Does ``cell`` report ``metric``: listed under its ``workloads``, or,
    without that key, a cell that reports the metric it moves (an
    end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def resolve(name: str, bench_dir: Path = BENCH_DIR, manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` of the manifest with every file it names loaded."""
    manifest = manifest or _load_json(manifest_path(bench_dir))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    config = _load_json(bench_dir.parent / entry["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(bench_dir / "limits" / f"{name}.json")
    e2e = [Metric(m["name"], m["unit"]) for m in manifest["end_to_end"] if _reports(m, name, [])]
    e2e_names = [m.name for m in e2e]
    per_layer = [Metric(m["name"], m["unit"], m["moves"])
                 for m in manifest["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer, bench_dir)


def all_cells(bench_dir: Path = BENCH_DIR) -> Dict[str, Cell]:
    manifest = _load_json(manifest_path(bench_dir))
    return {w["name"]: resolve(w["name"], bench_dir, manifest) for w in manifest["workloads"]}
