"""One run of one cell: set-up, the measured window, the check, the line.

``main`` is the command line (``portbench/run.py``): it refuses to run
without as many CUDA devices as the cell asks for, and measures only on
the card. ``run_cell`` takes the device as an argument so that the CPU
tests can drive a whole run at a tiny size; a CPU run writes no device
metric.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "pecanpy_tpu")


def derived_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one use of the run's seed (graph, call i, ...)."""
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(1)[0])


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _device_info(torch, device, n_chips):
    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": n_chips}
    return info


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return ["nvidia-smi not available"]


def set_up(cell, seed: int, device, diag: dict):
    """The graph from the seed, written and read back as the CLI reads it,
    the layout, and the warm-up on the cell's shapes. Returns (mode,
    entry, what the warm-up kept, the graph's CSR triple)."""
    from harness import entries
    from pecanpy_tpu_torch import pecanpy

    cfg = cell.config
    t0 = time.perf_counter()
    graph = cell.graph_generator().generate(derived_seed(seed, 0), **cfg["graph"]["params"],
                                            device=device)
    diag["graph_s"] = time.perf_counter() - t0
    indptr, indices, data = graph
    mode = getattr(pecanpy, cfg["mode"])(p=cfg["p"], q=cfg["q"], extend=cfg.get("extend", False),
                                         gamma=cfg.get("gamma", 0.0), device=device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = os.path.join(tmp, "graph.csr.npz")
        np.savez(path, indptr=indptr, indices=indices, data=data)
        mode.read_npz(path, weighted=True, implicit_ids=True)
    diag["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mode.get_device_graph()
    entries.sync(device)
    diag["layout_s"] = time.perf_counter() - t0
    entry = entries.make(mode, cfg, cell.traffic)
    warm_seed = derived_seed(seed, 3)
    t0 = time.perf_counter()
    warm = entry.warm_up(warm_seed)
    warm["seed"] = warm_seed
    entries.sync(device)
    diag["warmup_s"] = time.perf_counter() - t0
    return mode, entry, warm, graph


def run_cell(cell, seed: int, seconds: float, trace: bool, device_name: str, t_start: float):
    """Run ``cell`` once; returns (result dict, diagnostics dict)."""
    import torch

    from harness import check, entries, profiling, trace as tracing
    from reference import walklaw

    device = torch.device(device_name)
    cfg, traffic = cell.config, cell.traffic
    diag = {"cell": cell.name, "seed": seed}

    mode, entry, warm, graph = set_up(cell, seed, device, diag)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # -- the window ----------------------------------------------------------
    rec = tracing.Recorder()
    calls = []
    spans = tracing.spans(mode, rec, timed=True) if trace else contextlib.nullcontext()
    with spans:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            c0 = time.perf_counter()
            entry.call(derived_seed(seed, 2, len(calls)))
            entries.sync(device)
            calls.append(time.perf_counter() - c0)
        window_s = time.perf_counter() - w0
    diag.update(calls=len(calls), call_s=calls, window_s=window_s)

    result = {"correct": False, "attempted": len(calls), "failed": 0, "metrics": {}}
    metrics = {}
    prof = None
    if not trace:
        rate = entry.work() * len(calls) / window_s
        for m in cell.end_to_end:
            if m.name == "setup_s":
                metrics[m.name] = {"value": setup_s, "unit": m.unit}
            elif m.name == traffic["rate_metric"]:
                metrics[m.name] = {"value": rate, "unit": m.unit}
    else:
        if device.type == "cuda":
            prof_rec = tracing.Recorder()
            with tracing.spans(mode, prof_rec, timed=False):
                prof = profiling.profiled_call(
                    lambda: entry.call(derived_seed(seed, 5)), device)
            prof["recorder"] = prof_rec
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
            diag.update(busy_s=prof["busy_s"], profiled_window_s=prof["window_s"],
                        profile_reduce_s=prof["reduce_s"])
        ctx = dict(cell=cell, config=cfg, traffic=traffic, recorder=rec, calls=calls,
                   window_s=window_s, layout_s=diag["layout_s"], profile=prof, mode=mode,
                   device=device, entry=entry)
        for m in cell.per_layer:
            value = cell.metric_reader(m.name).read(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    if device.type != "cuda":  # a CPU run measures nothing: its numbers are diagnostics
        diag["cpu_numbers"], metrics = metrics, {}
    dev_info = _device_info(torch, device, cell.chips)
    if device.type == "cuda":
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        if prof is not None:
            dev_info["busy_s"] = prof["busy_s"]
            dev_info["window_s"] = prof["window_s"]
            prof.pop("result", None)

    # -- free the program's state, then the check ---------------------------
    last = entry.last
    entry.release()
    mode._device_graph = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = walklaw.RefGraph(*graph, device)
    check_seed = derived_seed(seed, 4)
    if traffic["entry"] == "walks":
        walks, eff = last
        numbers = check.walk_numbers(g, walks, eff, cfg, traffic["check"]["law_steps"],
                                     check_seed)
    else:
        numbers = check.embed_numbers(g, cfg, traffic, check_seed, warm, last, device)
    diag["check_s"] = time.perf_counter() - t0
    correct, checks = check.decide(numbers, cell.limits)
    diag["readings"] = numbers
    result.update(correct=correct, metrics=metrics, device=dev_info)
    result["checks"] = checks  # last key: each compared number with its limit
    return result, diag


def main(argv, t_start):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", help="also write the run's diagnostics as JSON here")
    args = ap.parse_args(argv)

    from harness import cells

    cell = cells.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, diag = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    diag["power"] = _power_limit()
    print(json.dumps({"diag": diag}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(result=result, diag=diag), f, indent=1)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
