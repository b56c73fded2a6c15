#!/usr/bin/env python3
"""Where the PyTorch port's time goes, on one NVIDIA GPU.

    python3 profile_port.py [--out chiprun_out/profile_port.txt]
                            [--sections walks,sgns,hub,stepsampler,precomp,apply,apply-sweep,
                                        trial-sweep,quality,multichip,cells,census,
                                        precomp-table]
                            [--trial-baseline OLD_TRIAL_CU] [--cells CELL,...]

Runs the configurations of ``chip_smoke.py`` (p=0.5, q=2, walks of 80
steps) and measures these steady-state windows:

- walks: on the main path's graph (the 1M-node, mean-degree-16 weighted
  graph of ``bench.py``), ``simulate_walks_device(1, 80)`` after a
  warm-up;
- SGNS: on the same walks, ``WINDOW_STEPS`` chunk-steps of
  ``make_step_body`` (dim 128, window 10, bf16 tables) after
  ``WARMUP_STEPS`` (the step ``sgns.train`` runs, without its setup and
  final table fetch);
- hub: on the hub path's graph (the 1M-node Chung-Lu power-law graph of
  ``benchmarks/bench_powerlaw.py``), one dispatch of the queued engine:
  262,144 walks of 80 steps on 32,768 lanes, reported per round, with
  every op of the round by device time;
- stepsampler: on the same graph under ``PECANPY_TPU_AMORTIZED=0`` (no
  cdf channel), one chunk of 32,768 walks of 80 steps through the scan
  engine and the per-step sampler (``rejection.second_order_sample``),
  reported per walk step, with its sweeps per step and the top ops;
- precomp: on the main path's graph, the PreComp edge-CDF build (host
  clock), its ``simulate_walks_device(1, 80)``, and the SGNS window on
  those walks with the windowed applier (``PECANPY_TPU_APPLY_V2``);
- apply: no graph; ``chip_smoke.py``'s applier streams (phase 3's W_in
  and W_out, phase 7a's hot-row and block-boundary ones) into a
  [1M, 128] table, f32 and bf16: both appliers and ``index_add_`` by
  device time and by CUDA events beside the bound, and the wrappers'
  host time with the share of their checks. Under a minute;
- apply-sweep: no graph; kernel 2.1 built with other values of its
  constants (``APPLY_SWEEP``) against the committed build on the same
  streams, by device time, in turns;
- trial-sweep: on the hub path's graph, ``chip_smoke.py`` 6b's 32,768
  edge lanes (2 trials, cdf channel); both trial kernels built from
  ``--trial-baseline`` (an earlier ``csrc/trial.cu`` whose kernels take
  gathered rows, e.g. ``git show dfb011c:pecanpy_tpu_torch/csrc/trial.cu``),
  from the committed source, and with other values of its constants
  (``TRIAL_SWEEP``), each build in a process of its own, in turns; every
  build is held bit-equal to the plain halves before it is timed;
- multichip: on the main path's graph, 2 ranks sharing the card over
  gloo (``pecanpy_tpu_torch/parallel``), ``MULTICHIP_STEPS`` fused
  walk + SGNS steps of ``MultichipTrainer`` per rank after one warm-up
  step, replicated and edge-partitioned, each under ``torch.profiler``
  in its rank: host and device-busy ms a step, idle share, the host time
  in the collective wrappers (the gloo calls, whose copies of CUDA tensors
  through the host included), the device time of those copies, and the
  rest (the step body);
- quality: ``chip_smoke.py`` phase 8's protocol graph (10,312 nodes, read
  by the native parser), the two arms too slow for every smoke run: the
  batched trainer at epochs=2 and the sequential trainer on one thread
  (the strictly sequential reference), each scored by the protocol's
  micro-F1 (and at split seeds 0-4, the spread of the split alone) with
  its seconds; then the SGNS window on that graph's walks
  (13 walks a chunk-step, f32 tables);
- cells: cells of ``BENCHMARK.json`` (``--cells``; default
  uniform1m.embed and powerlaw1m.walks) set up as ``portbench/`` sets
  them up, each traced from inside the port (``utils/trace.py``): the
  layout's phases, one call timed and one profiled, the call's spans and
  counters (an untraced call's), and the enabled level's cost (calls in
  turns, tracing off and on);
- census: every cell (or ``--cells``), one call under
  ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing
  operations CUDA reports, by site, against the job's ``syncs`` counter;
  first the host cost of one span at each tracing level;
- precomp-table: ``uniform1m.precomp``'s graph from each of
  ``--table-seeds`` (as a benchmark run makes it from its seed), its
  PreComp table (the job ``pecanpy.precomp``) held row by row to
  ``portbench/reference/precomp_table.py``, with the table rounded to
  bfloat16 as the precision that must fail, the first-order channel
  too; then one call's walks at the configuration's q, one from the same
  table rounded to bfloat16, and the control's, the same instance
  rebuilt at q = 1, all judged by the configuration's law as the
  benchmark's check judges them (``law_z``). It stands in for a check
  of the table in ``portbench/``, whose walk check reads walks alone. A
  JSON line a seed goes to ``precomp_table.jsonl`` beside ``--out``.

Each window is timed twice: on the host clock with a synchronize at each
end (ms per step, rate), and under ``torch.profiler`` with the port's
tracing enabled (device time by op; device idle share = 1 - summed kernel
time / host-clock window; each idle gap between kernels put down to the
innermost port span the host was in, ``pecanpy.*`` device annotations
left out of the kernels).
Prints a summary; the full op tables go to ``--out``.
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP_STEPS = 5
WINDOW_STEPS = 20
MULTICHIP_STEPS = 5
TOP_OPS = 25


def log(msg):
    print(msg, flush=True)


def span_labels(records):
    """A function ``t_ns -> name`` of the innermost span of ``records`` (the
    port's span log, ``trace.spans()``, in its order) that holds the unix
    time ``t_ns``, or None. Spans nest, so only the last span to start
    before ``t_ns`` and its ancestors can hold it."""
    import bisect

    starts = [rec.start_ns for rec in records]

    def at(t_ns):
        k = bisect.bisect_right(starts, t_ns) - 1
        while k >= 0:
            rec = records[k]
            if rec.end_ns >= t_ns or rec.end_ns == 0:  # 0: still open
                return rec.name
            k = rec.parent
        return None

    return at


def idle_gaps(prof, logged, top=8):
    """The idle stretches between the kernels of a finished profile, each
    put down to the innermost port span (``utils/trace.py``, enabled while
    it ran) the host was in at the gap's middle, else "host":
    [(label, seconds)], the ``top`` largest sums. The device annotations
    the profiler mirrors from the port's ranges (``pecanpy.*``) are not
    kernels."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    from pecanpy_tpu_torch.utils import trace

    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA
                     and not e.name().startswith(trace.PREFIX))
    label_at = span_labels(logged)
    gaps = defaultdict(float)
    end = None
    for lo, hi in kernels:
        if end is not None and lo > end:
            gaps[label_at((lo + end) // 2) or "host"] += (lo - end) * 1e-9
        end = hi if end is None else max(end, hi)
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]


def profiled(fn, label, out, top=8):
    """Run ``fn`` once on the host clock and once under the profiler with
    the port's tracing enabled, printing its ``top`` ops by device time
    and the idle gaps by port span; returns (host seconds, device-busy
    seconds or None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import self_device_us
    from pecanpy_tpu_torch.utils import trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0

    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        trace.disable()
    events = prof.key_averages()
    # an op's device time shows twice: on its aten op (host side) and on
    # the kernels it launched (device side); busy time sums the kernels,
    # not the annotations the profiler mirrors from the port's ranges
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.key.startswith(trace.PREFIX)]
    busy_us = sum(self_device_us(e) for e in kernels)
    gaps = idle_gaps(prof, trace.spans())
    log("    idle gaps by port span: " + ", ".join(f"{k} {v:.4f} s" for k, v in gaps))
    table = events.table(sort_by="self_cuda_time_total", row_limit=TOP_OPS)
    out.write(f"== {label}\n{table}\n")
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    for e in sorted(ops, key=self_device_us, reverse=True)[:top]:
        if self_device_us(e) > 0:
            log(f"    {e.key[:40]:40s} {self_device_us(e) / 1e3:9.3f} ms device, "
                f"{e.count} calls")
    for e in kernels:  # the port's own kernels have no aten op
        for tag in ("apply_sorted_kernel", "apply_windowed_kernel", "trial_propose_kernel",
                    "trial_accept_kernel"):
            if tag in e.key:
                log(f"    {'csrc: ' + tag:40s} {self_device_us(e) / 1e3:9.3f} ms device, "
                    f"{e.count} calls")
    return host_s, (busy_us / 1e6 if busy_us > 0 else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "profile_port.txt"))
    ap.add_argument("--sections", default="walks,sgns,hub,precomp",
                    help="comma-separated subset of walks, sgns, hub, stepsampler, precomp, "
                         "apply, apply-sweep, trial-sweep, quality, multichip, cells, census, "
                         "precomp-table")
    ap.add_argument("--apply-lib", help="with --sections apply-lib: time kernel 2.1 "
                    "from this build of the library (the sweep's own processes)")
    ap.add_argument("--trial-baseline", help="with --sections trial-sweep: an earlier "
                    "csrc/trial.cu whose kernels take gathered rows, timed first")
    ap.add_argument("--cells", default=None,
                    help="with --sections cells or census: comma-separated cells of "
                         "BENCHMARK.json (default: uniform1m.embed,powerlaw1m.walks for "
                         "cells, every cell for census)")
    ap.add_argument("--table-seeds", default="2147483901,2147483902,2147483903",
                    help="with --sections precomp-table: comma-separated run seeds")
    ap.add_argument("--trial-lib", nargs=3, metavar=("LIB", "INPUTS", "DESIGN"),
                    help="with --sections trial-lib: time the trial kernels of LIB on the "
                    "saved lanes INPUTS; DESIGN is ids or rows (the sweep's own processes)")
    args = ap.parse_args()
    sections = set(args.sections.split(","))

    import tempfile

    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import nvidia_smi_line

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {nvidia_smi_line()}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    with tempfile.TemporaryDirectory() as tmp, open(args.out, "w") as out:
        if "apply" in sections:
            profile_apply()
        if "apply-sweep" in sections:
            sweep_apply()
        if "apply-lib" in sections:
            time_apply_lib(args.apply_lib)
        if "trial-sweep" in sections:
            if not args.trial_baseline:
                raise SystemExit("--sections trial-sweep needs --trial-baseline")
            sweep_trial(tmp, args.trial_baseline)
        if "trial-lib" in sections:
            time_trial_lib(*args.trial_lib)
        if sections & {"walks", "sgns", "precomp"}:
            profile_main(tmp, out, sections)
        if "hub" in sections:
            profile_hub(tmp, out)
        if "stepsampler" in sections:
            profile_stepsampler(tmp, out)
        if "quality" in sections:
            profile_quality(tmp, out)
        if "multichip" in sections:
            profile_multichip(tmp, out)
        if "census" in sections:
            sync_census(args.cells.split(",") if args.cells else None)
        if "cells" in sections:
            cells = args.cells or "uniform1m.embed,powerlaw1m.walks"
            profile_cells(out, cells.split(","))
        if "precomp-table" in sections:
            precomp_table([int(x) for x in args.table_seeds.split(",")],
                          os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                       "precomp_table.jsonl"))
        log(f"[done] op tables in {os.path.relpath(args.out, REPO)}")


def profile_main(tmp, out, sections):
    import torch

    from chip_smoke import MEAN_DEGREE, NODES, build_bench_graph
    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.ops import apply as apply_lib

    indptr, indices, data = build_bench_graph(NODES, MEAN_DEGREE)
    path = os.path.join(tmp, "bench_graph.csr.npz")
    np.savez(path, indptr=indptr, indices=indices, data=data)
    if sections & {"walks", "sgns"}:
        g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=0, device="cuda")
        g.read_npz(path, weighted=True, implicit_ids=True)
        g.preprocess_transition_probs()
        walks, eff = profile_walks(g, "walks", out)
        del g
        if "sgns" in sections:
            profile_sgns(walks, eff, "sgns", out)
        del walks, eff
        torch.cuda.empty_cache()
    if "precomp" not in sections:
        return
    g = pecanpy.PreComp(p=0.5, q=2.0, random_state=0, device="cuda")
    g.read_npz(path, weighted=True, implicit_ids=True)
    g.get_device_graph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g.preprocess_transition_probs()
    torch.cuda.synchronize()
    log(f"[precomp] edge-CDF build {time.perf_counter() - t0:.4f} s host clock, "
        f"edge_cdf {tuple(g.edge_cdf.shape)}")
    walks, eff = profile_walks(g, "precomp walks", out)
    del g
    v2 = apply_lib.APPLY_V2
    apply_lib.APPLY_V2 = True
    try:
        run = profile_sgns(walks, eff, "sgns, windowed applier", out)
        # the two applier routes in turns on the same steps, host clock
        times = []
        for flag in (False, True, True, False):
            apply_lib.APPLY_V2 = flag
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(WARMUP_STEPS, WINDOW_STEPS)
            torch.cuda.synchronize()
            times.append(f"{'windowed' if flag else 'kernel 2.1'} "
                         f"{1e3 * (time.perf_counter() - t0) / WINDOW_STEPS:.4f}")
        log(f"[sgns routes] ms per chunk-step in turns: {', '.join(times)}")
    finally:
        apply_lib.APPLY_V2 = v2


def profile_walks(g, label, out):
    """``simulate_walks_device(1, 80)`` of mode ``g`` after a warm-up."""
    import torch

    from chip_smoke import NODES, WALK_LENGTH

    g.simulate_walks_device(1, 8)  # warm-up
    result = {}

    def walk():
        result["walks"] = g.simulate_walks_device(1, WALK_LENGTH)

    log(f"[{label}] simulate_walks_device(1, 80), top ops by device time:")
    host_s, busy_s = profiled(walk, label, out)
    walks, eff = result["walks"]
    steps = float((eff.to(torch.int64) - 1).sum())
    chunks = -(-NODES // 131_072)
    log(f"[{label}] {host_s:.4f} s host clock: {steps / host_s:.4e} effective "
        f"steps/s, {1e3 * host_s / (chunks * WALK_LENGTH):.4f} ms per step "
        f"of {chunks} chunks x {WALK_LENGTH}")
    if busy_s is not None:
        log(f"[{label}] device busy {busy_s:.4f} s under the profiler, "
            f"{1e3 * busy_s / (chunks * WALK_LENGTH):.4f} ms per step: idle "
            f"share {1 - busy_s / host_s:.4f} of the host-clock window")
    return walks, eff


def profile_sgns(walks, eff, label, out, num_nodes=None):
    """``WINDOW_STEPS`` chunk-steps of the SGNS step ``sgns.train`` runs,
    set up the way ``train`` sets it up, on ``walks`` of a graph of
    ``num_nodes`` nodes (default: the main path's). Returns the
    ``run(first step, count)`` callable it timed."""
    import torch

    from chip_smoke import DIM, NODES, WINDOW
    from pecanpy_tpu_torch.models import sgns

    n = num_nodes or NODES
    config = sgns.SGNSConfig(dim=DIM, window=WINDOW, seed=0)
    counts = sgns._count_tokens(walks, eff, n)
    keep_prob = sgns._keep_probs(counts, config.sample)
    neg_table = torch.from_numpy(
        sgns.build_negative_table(counts.cpu().numpy(), seed=0)).cuda()
    dtype = sgns.resolve_table_dtype(config, n, "cuda")
    w_in, w_out = sgns.init_tables(0, n, DIM, dtype, "cuda")
    chunk = sgns.resolve_batch_walks(config, n, walks.shape[1])
    step = sgns.make_step_body(n, config)
    t = walks.shape[1]
    eff_host = eff.cpu().numpy()

    def run(first, count):
        for i in range(first, first + count):
            sl = slice(i * chunk, (i + 1) * chunk)
            step(w_in, w_out, walks[sl], eff[sl], keep_prob, neg_table,
                 config.alpha,
                 sgns.draw_step(0, i, chunk, t, config, neg_table.shape[0], "cuda"))

    run(0, WARMUP_STEPS)
    a = WARMUP_STEPS
    tokens = float(eff_host[a * chunk:(a + WINDOW_STEPS) * chunk].sum())
    log(f"[{label}] {WINDOW_STEPS} chunk-steps of {chunk} walks ({dtype}), "
        "top ops by device time:")
    host_s, busy_s = profiled(lambda: run(a, WINDOW_STEPS), label, out)
    log(f"[{label}] {host_s:.4f} s host clock: {1e3 * host_s / WINDOW_STEPS:.4f} ms "
        f"per chunk-step, {tokens / host_s:.4e} tokens/s")
    if busy_s is not None:
        log(f"[{label}] device busy {1e3 * busy_s / WINDOW_STEPS:.4f} ms per "
            f"chunk-step under the profiler: idle share "
            f"{1 - busy_s / host_s:.4f} of the host-clock window")
    return run


def apply_streams(n, d, grid):
    """``chip_smoke.py``'s applier streams into an [n, d] table: phase 3's
    W_in and W_out streams and phase 7a's hot-row and block-boundary ones
    (``grid``: the windowed kernel's blocks)."""
    from chip_smoke import (NEG_POOL, WALK_LENGTH, make_boundary_stream, make_hot_stream,
                            make_stream)

    r_in = 1235 * (WALK_LENGTH + 1)
    streams = {f"R={r}": make_stream(r, n, d, seed=r) for r in (r_in, r_in + NEG_POOL)}
    streams["hot"] = make_hot_stream(r_in, n, d, seed=7)
    streams["boundary"] = make_boundary_stream(r_in, n, d, grid, seed=13)
    return streams


def profile_apply(host_calls=200):
    """Both appliers and ``index_add_`` on the applier streams of
    ``chip_smoke.py``, and the windowed wrapper's host time per call."""
    import torch

    from chip_smoke import DIM, HBM_BYTES_PER_S, NODES, cuda_median_ms, device_ms
    from pecanpy_tpu_torch.ops import apply as apply_lib

    n, d = NODES, DIM
    base = (torch.rand(n, d, device="cuda") - 0.5) / d
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        table = base.to(dtype)
        grid = apply_lib.windowed_grid(table, base)
        for label, (ids_s, upd_s) in apply_streams(n, d, grid).items():
            r = ids_s.numel()
            ids_l, upd_l = ids_s.long(), upd_s.to(dtype)
            calls = {
                "windowed": lambda: apply_lib.apply_sorted_stream_windowed(table, ids_s, upd_s, 1),
                "2.1": lambda: apply_lib.apply_sorted_stream(table, ids_s, upd_s, 1),
                "index_add_": lambda: table.index_add_(0, ids_l, upd_l, alpha=-1),
            }
            touched = int(torch.unique_consecutive(ids_s).numel())
            nbytes = r * 4 + r * d * 4 + 2 * touched * d * table.element_size()
            times = ", ".join(f"{k} {device_ms(fn):.4f} / {cuda_median_ms(fn):.4f}"
                              for k, fn in calls.items())
            log(f"[apply] {name} {label} (R={r}): ms device / CUDA events: {times}; bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB)")
            if not label.startswith("R="):
                continue
            # host time of one wrapper call: the checks alone, then the whole
            # call (the launches queue; the device catches up afterwards)
            host = {}
            for what, fn in (
                ("checks", lambda: apply_lib._check_cuda_stream(
                    table, ids_s, upd_s, "apply_sorted_stream_windowed")),
                ("windowed", calls["windowed"]),
                ("2.1", calls["2.1"]),
            ):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(host_calls):
                    fn()
                host[what] = 1e3 * (time.perf_counter() - t0) / host_calls
                torch.cuda.synchronize()
            log(f"[apply] {name} {label}: wrapper host time per call: windowed "
                f"{host['windowed']:.4f} ms, 2.1 {host['2.1']:.4f} ms; the checks "
                f"{host['checks']:.4f} ms of each")
            del ids_s, upd_s, ids_l, upd_l
        del table
    del base
    torch.cuda.empty_cache()


# kernel 2.1's constants in csrc/apply.cu, and the variants the sweep builds:
# (kLongRows, kSlab, kStageRows, kStages)
APPLY_CONSTANTS = ("kLongRows", "kSlab", "kStageRows", "kStages")
APPLY_SWEEP = [
    (32, 32, 16, 8), (32, 32, 16, 16), (32, 16, 64, 12), (32, 8, 64, 12), (32, 8, 128, 12),
    (32, 4, 64, 12), (32, 4, 128, 12), (32, 4, 512, 4), (32, 4, 256, 12),
    (16, 4, 256, 8), (64, 4, 256, 8), (128, 4, 256, 8),
]


def sweep_apply(variants=APPLY_SWEEP):
    """Kernel 2.1 built with other values of its constants (a copy of
    ``csrc/`` with them replaced, built in parallel into ``build/sweep``),
    each timed in a process of its own (``--apply-lib``) after the
    committed build and before it again."""
    import re
    import shutil
    import subprocess
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from pecanpy_tpu_torch.ops import _kernels

    source = (_kernels.CSRC_DIR / "apply.cu").read_text()
    pattern = r"constexpr int {} = (\d+);"
    committed = tuple(int(re.search(pattern.format(k), source).group(1))
                      for k in APPLY_CONSTANTS)
    with tempfile.TemporaryDirectory() as tmp:
        def build(values):
            src = Path(tmp) / "_".join(map(str, values))
            shutil.copytree(_kernels.CSRC_DIR, src)
            text = source
            for key, value in zip(APPLY_CONSTANTS, values):
                text = re.sub(pattern.format(key), f"constexpr int {key} = {value};", text)
            (src / "apply.cu").write_text(text)
            return _kernels.build(src, _kernels.BUILD_DIR / "sweep")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(variants) + 1) as pool:
            paths = list(pool.map(build, [committed, *variants]))
    log(f"[sweep] {len(variants)} variants of csrc/apply.cu built in "
        f"{time.perf_counter() - t0:.1f} s; constants {APPLY_CONSTANTS}")
    runs = [(committed, paths[0]), *zip(variants, paths[1:]), (committed, paths[0])]
    for values, path in runs:
        log(f"[sweep] {dict(zip(APPLY_CONSTANTS, values))}"
            f"{' (committed)' if values == committed else ''}:")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--sections", "apply-lib",
                        "--apply-lib", str(path)], check=True)


def time_apply_lib(path):
    """Kernel 2.1 from the library at ``path`` on the applier streams, by
    device time, each stream to the bit the plain version."""
    import ctypes

    import torch

    from chip_smoke import DIM, NODES, assert_bit_equal, device_ms
    from pecanpy_tpu_torch.ops import _kernels
    from pecanpy_tpu_torch.ops import apply as apply_lib

    lib = _kernels.bind(ctypes.CDLL(path))
    _kernels.load = lambda: lib
    n, d = NODES, DIM
    base = (torch.rand(n, d, device="cuda") - 0.5) / d
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        table0 = base.to(dtype)
        grid = apply_lib.windowed_grid(table0, base)
        times = []
        for label, (ids_s, upd_s) in apply_streams(n, d, grid).items():
            want = apply_lib.apply_sorted_stream_plain(table0.clone(), ids_s, upd_s, 1)
            got = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, 1)
            assert_bit_equal(f"{name} {label}", got, want)
            del got, want
            table = table0.clone()
            ms = device_ms(lambda: apply_lib.apply_sorted_stream(table, ids_s, upd_s, 1))
            times.append(f"{label} {ms:.4f}")
            del table
        log(f"[sweep]   {name}, device ms (bit-equal to plain): {', '.join(times)}")


def hub_graph(tmp):
    """The hub path's power-law graph through ``SparseOTF(p=0.5, q=2)``:
    (the mode, its device graph, indptr, indices)."""
    from chip_smoke import NODES, build_powerlaw_graph
    from pecanpy_tpu_torch import pecanpy

    indptr, indices, data = build_powerlaw_graph(NODES)
    path = os.path.join(tmp, "powerlaw_graph.csr.npz")
    np.savez(path, indptr=indptr, indices=indices, data=data)
    g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=0, device="cuda")
    g.read_npz(path, weighted=True, implicit_ids=True)
    g.preprocess_transition_probs()
    return g, g.get_device_graph(), indptr, indices


def profile_hub(tmp, out):
    """One queued-engine dispatch on the power-law graph, per round, with
    every op of the round."""
    import torch

    from chip_smoke import HUB_LANES, TRIALS, WALK_LENGTH
    from pecanpy_tpu_torch.models import engine

    g, dg, _, _ = hub_graph(tmp)
    walks_per = HUB_LANES * g._walk_queue_factor()
    starts = torch.from_numpy(g._start_nodes(1)[:walks_per]).cuda()
    result = {}

    def dispatch(chunk_idx):
        draws = engine.TrialDrawStream(0, chunk_idx, TRIALS, "cuda")
        result["out"] = engine.generate_walks_queued(
            dg, starts, draws, WALK_LENGTH, g.p, g.q, False, lanes=HUB_LANES,
            return_rounds=True)

    dispatch(0)  # warm-up
    log(f"[hub] queued engine, {walks_per} walks of {WALK_LENGTH} steps on "
        f"{HUB_LANES} lanes, every op with device time:")
    host_s, busy_s = profiled(lambda: dispatch(1), "hub", out, top=100)
    _, eff, rounds = result["out"]
    steps = float((eff.to(torch.int64) - 1).sum())
    log(f"[hub] {host_s:.4f} s host clock, {rounds} rounds (each run): "
        f"{1e3 * host_s / rounds:.4f} ms per round, {steps / host_s:.4e} "
        "effective steps/s")
    if busy_s is not None:
        log(f"[hub] device busy {1e3 * busy_s / rounds:.4f} ms per round under the "
            f"profiler: idle share {1 - busy_s / host_s:.4f} of the host-clock window")


def profile_stepsampler(tmp, out):
    """One chunk of the scan engine with the per-step hub sampler on the
    power-law graph, per walk step, with its top ops."""
    import torch

    from chip_smoke import HUB_LANES, WALK_LENGTH, env_set
    from pecanpy_tpu_torch.ops import rejection
    from pecanpy_tpu_torch.utils import trace

    with env_set(PECANPY_TPU_AMORTIZED="0"):
        g, dg, _, _ = hub_graph(tmp)
        if "cdf" in dg.channels or g._walk_queue_factor() != 1:
            raise AssertionError("the per-step sampler's layout has no cdf channel")
        run = g._make_walk_runner(WALK_LENGTH)
        starts = torch.from_numpy(g._start_nodes(1)[:HUB_LANES]).cuda()
        sweeps = []
        sample = rejection.second_order_sample

        def counted(*args, **kwargs):
            with trace.job("pecanpy.profile.sample"):
                nxt = sample(*args, **kwargs)
            sweeps.append(trace.last_job("pecanpy.profile.sample").counter("walk.sweeps"))
            return nxt

        result = {}

        def chunk(chunk_idx):
            result["out"] = run(dg, starts, chunk_idx)

        rejection.second_order_sample = counted
        try:
            chunk(0)  # warm-up
            sweeps.clear()
            log(f"[stepsampler] scan engine + per-step sampler, {HUB_LANES} walks of "
                f"{WALK_LENGTH} steps, top ops by device time:")
            host_s, busy_s = profiled(lambda: chunk(1), "stepsampler", out, top=30)
        finally:
            rejection.second_order_sample = sample
    _, eff = result["out"]
    steps = float((eff.to(torch.int64) - 1).sum())
    n_steps = WALK_LENGTH - 1
    sw = np.array(sweeps[: len(sweeps) // 2])  # the host-clock run's calls
    if not 0 < sw.max() < rejection.SWEEP_CAP:
        raise AssertionError(f"sweeps a step max {sw.max()} (cap {rejection.SWEEP_CAP})")
    log(f"[stepsampler] {host_s:.4f} s host clock: {1e3 * host_s / n_steps:.4f} ms per walk "
        f"step, {steps / host_s:.4e} effective steps/s; sweeps a step mean {sw.mean():.2f}, "
        f"max {int(sw.max())}")
    if busy_s is not None:
        log(f"[stepsampler] device busy {1e3 * busy_s / n_steps:.4f} ms per walk step under "
            f"the profiler: idle share {1 - busy_s / host_s:.4f} of the host-clock window")


# the trial kernels' constants in csrc/trial.cu, and the variants the sweep
# builds: (kGroup, kMinBlocks)
TRIAL_CONSTANTS = ("kGroup", "kMinBlocks")
TRIAL_SWEEP = [(4, 8), (8, 8), (8, 4), (16, 4), (32, 4)]


def sweep_trial(tmp, baseline, variants=TRIAL_SWEEP):
    """Both trial kernels from ``baseline`` (an earlier ``csrc/trial.cu``
    on gathered rows), from the committed source, and with other values
    of its constants, on ``chip_smoke.py`` 6b's lanes: each build in a
    process of its own (``--trial-lib``), in the order baseline,
    committed, variants, committed, baseline."""
    import re
    import shutil
    import subprocess
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from chip_smoke import hub_trial_lanes
    from pecanpy_tpu_torch.ops import _kernels

    _, dg, indptr, indices = hub_graph(tmp)
    lanes, pqa = hub_trial_lanes(indptr, indices, dg)
    inputs = os.path.join(tmp, "trial_inputs.pt")
    fields = ("fused", "deg", "threshold", "indptr", "edge_pack", "hbuckets", "channels",
              "dpad", "max_degree", "gamma", "has_hubs", "symmetric", "hub_frac")
    torch.save(dict(dg={k: getattr(dg, k) for k in fields}, lanes=lanes, pqa=pqa), inputs)
    del dg, lanes
    torch.cuda.empty_cache()

    source = (_kernels.CSRC_DIR / "trial.cu").read_text()
    pattern = r"constexpr int {} = (\d+);"
    committed = tuple(int(re.search(pattern.format(k), source).group(1))
                      for k in TRIAL_CONSTANTS)

    def build(name, text):
        src = Path(tmp) / f"csrc_{name}"
        shutil.copytree(_kernels.CSRC_DIR, src)
        (src / "trial.cu").write_text(text)
        return _kernels.build(src, _kernels.BUILD_DIR / "sweep")

    def variant(values):
        text = source
        for key, value in zip(TRIAL_CONSTANTS, values):
            text = re.sub(pattern.format(key), f"constexpr int {key} = {value};", text)
        return text

    t0 = time.perf_counter()
    jobs = [("baseline", Path(baseline).read_text())] + [
        ("_".join(map(str, v)), variant(v)) for v in (committed, *variants)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip([name for name, _ in jobs], pool.map(lambda j: build(*j), jobs)))
    log(f"[trial-sweep] {len(jobs)} builds of csrc/trial.cu in "
        f"{time.perf_counter() - t0:.1f} s; constants {TRIAL_CONSTANTS}, committed "
        f"{committed}; baseline {baseline}")
    key = "_".join(map(str, committed))
    order = ["baseline", key, *["_".join(map(str, v)) for v in variants], key, "baseline"]
    for name in order:
        label = "baseline" if name == "baseline" else dict(zip(TRIAL_CONSTANTS, map(
            int, name.split("_"))))
        log(f"[trial-sweep] {label}{' (committed)' if name == key else ''}:")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--sections", "trial-lib",
                        "--trial-lib", str(paths[name]), inputs,
                        "rows" if name == "baseline" else "ids"], check=True)


def _rows_design(lib, dg, draws, prev, cur, theta, wp, p, q, alpha_np):
    """The two kernels of a ``csrc/trial.cu`` whose entry points take
    gathered rows (``dfb011c``'s interface), as calls of the id
    interface's shape: (propose(), accept(x, wx))."""
    import ctypes

    import torch

    from pecanpy_tpu_torch.ops.hubs import EP_WIDTH
    from pecanpy_tpu_torch.ops.layout import HB_WIDTH

    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.pecanpy_trial_propose.argtypes = [ptr, i64, i32, i32, ptr, i64, ptr, ptr, ptr, ptr,
                                          ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.pecanpy_trial_accept.argtypes = [ptr, i64, i32, ptr, i64, ptr, ptr, ptr, ptr, ptr,
                                         f32, f32, f32, i32, ptr, ptr, ptr, i64, i32, i32,
                                         ptr]
    rows_c, rows_p = dg.gather_rows(cur), dg.gather_rows(prev)
    trials, b = draws.kk.shape
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.empty((trials, b), dtype=torch.int32, device="cuda")
    w = torch.empty((trials, b), dtype=torch.float32, device="cuda")
    chosen = torch.empty(b, dtype=torch.int32, device="cuda")
    got = torch.empty(b, dtype=torch.bool, device="cuda")
    chosen_w = torch.empty(b, dtype=torch.float32, device="cuda")

    def propose():
        code = lib.pecanpy_trial_propose(
            rows_c.data_ptr(), rows_c.shape[1], dg.dpad, dg.channels.index("cdf") * dg.dpad,
            dg.edge_pack.data_ptr(), dg.edge_pack.numel() // EP_WIDTH, draws.kk.data_ptr(),
            draws.u.data_ptr(), theta.data_ptr(), wp.data_ptr(), prev.data_ptr(),
            x.data_ptr(), w.data_ptr(), b, trials, dg.num_nodes, stream)
        assert code == 0, code
        return x, w

    def accept(xs, ws):
        code = lib.pecanpy_trial_accept(
            rows_p.data_ptr(), rows_p.shape[1], dg.dpad, dg.hbuckets.data_ptr(),
            dg.hbuckets.numel() // HB_WIDTH, xs.data_ptr(), ws.data_ptr(), draws.u.data_ptr(),
            prev.data_ptr(), None, 1.0 / p, 1.0 / q, alpha_np, 1, chosen.data_ptr(),
            got.data_ptr(), chosen_w.data_ptr(), b, trials, dg.num_nodes, stream)
        assert code == 0, code
        return chosen, got, chosen_w

    return propose, accept


def time_trial_lib(path, inputs, design):
    """Both trial kernels from the library at ``path`` on the saved lanes:
    held bit-equal to the plain halves, then timed by device time (mean of
    20) and CUDA events (median of 20)."""
    import ctypes

    import torch

    from chip_smoke import cuda_median_ms, device_ms
    from pecanpy_tpu_torch.ops import _kernels, trialkernel
    from pecanpy_tpu_torch.ops.layout import DeviceCSR
    from pecanpy_tpu_torch.ops.rejection import RoundDraws

    saved = torch.load(inputs, map_location="cuda")
    dg = DeviceCSR(**saved["dg"])
    lanes = saved["lanes"]
    cur, prev, theta, wp = (lanes[k] for k in ("cur", "prev", "theta", "wp"))
    draws = RoundDraws(lanes["kk"], lanes["u"])
    p, q, alpha_np = saved["pqa"]
    x_p, wx_p = trialkernel.trial_propose_plain(dg, draws, prev, cur, theta, wp, True)
    acc_p = trialkernel.trial_accept_plain(dg, draws, x_p, wx_p, prev, p, q, alpha_np, True)
    lib = ctypes.CDLL(path)
    if design == "ids":
        _kernels.bind(lib)
        _kernels.load = lambda: lib
        propose = lambda: trialkernel.trial_propose(dg, draws, prev, cur, theta, wp, True)
        accept = lambda xs, ws: trialkernel.trial_accept(
            dg, draws, xs, ws, prev, p, q, alpha_np, True)
    else:
        propose, accept = _rows_design(lib, dg, draws, prev, cur, theta, wp, p, q, alpha_np)
    for label, got, want in (("propose", propose(), (x_p, wx_p)),
                             ("accept", accept(x_p, wx_p), acc_p)):
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, want)):
            raise AssertionError(f"trial {label} differs from its plain version")
    times = []
    for label, fn in (("trial_propose", propose), ("trial_accept", lambda: accept(x_p, wx_p))):
        times.append(f"{label} {device_ms(fn):.4f} / {cuda_median_ms(fn):.4f} / "
                     f"{cold_kernel_ms(fn, label):.4f}")
    log(f"[trial-sweep]   bit-equal to plain; ms device / CUDA events / device with a cold "
        f"L2: {', '.join(times)}")


def cold_kernel_ms(fn, name, reps=20):
    """Mean device time of the kernels named ``name`` that ``fn`` launches,
    each launch after a 128 MB write that evicts the 50 MB L2, as a walk
    round meets the rows: under ``torch.profiler``, the write's own
    kernel left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import self_device_us

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device activity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(self_device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError(f"torch.profiler recorded no {name} kernel in three sessions")


def profile_quality(tmp, out):
    """The quality protocol's slow arms and its SGNS window (see the module
    docstring); prints one ``{"quality_profile": ...}`` JSON line."""
    import json

    import torch

    from chip_smoke import (
        DIM, QUALITY_COMMUNITIES, QUALITY_MEAN_DEGREE, QUALITY_NODES, WALK_LENGTH, WINDOW,
        run_captured, sequential_pairs, timer_seconds, write_edg,
    )
    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.utils import evaluate

    indptr, indices, _, labels = evaluate.overlapping_sbm(
        n=QUALITY_NODES, n_communities=QUALITY_COMMUNITIES,
        mean_degree=QUALITY_MEAN_DEGREE, seed=1)
    path = os.path.join(tmp, "quality_sbm.edg")
    write_edg(path, indptr, indices)
    g = pecanpy.SparseOTF(random_state=0, workers=1, device="cuda")
    g.read_edg(path, weighted=True, directed=False, engine="native")
    labels = labels[np.array([int(x) for x in g.nodes])]
    record = {}

    def score(emb):
        """micro-F1 at the protocol's split (seed 0), and at split seeds 0-4:
        the spread the evaluation's split alone gives one embedding."""
        f1 = [evaluate.multilabel_node_classification(
            emb, labels, train_fraction=0.5, seed=s, device="cuda") for s in range(5)]
        return f1[0], f1

    t0 = time.perf_counter()
    emb, text = run_captured(g.embed, dim=DIM, num_walks=10, walk_length=WALK_LENGTH,
                             window_size=WINDOW, epochs=2, verbose=True)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    f1, by_split = score(emb)
    record["batched_epochs2"] = {
        "micro_f1": f1, "micro_f1_split_seeds_0_4": by_split, "embed_s": embed_s,
        "walk_s": timer_seconds(text, "generate walks"),
        "train_s": timer_seconds(text, "train embeddings")}
    log(f"[quality] batched, epochs=2: {record['batched_epochs2']}")

    t0 = time.perf_counter()
    emb, text = run_captured(g.embed, dim=DIM, num_walks=10, walk_length=WALK_LENGTH,
                             window_size=WINDOW, epochs=1, trainer="sequential",
                             verbose=True)
    embed_s = time.perf_counter() - t0
    pairs = sequential_pairs(text)[0]
    train_s = timer_seconds(text, "train embeddings (sequential)")
    f1, by_split = score(emb)
    record["sequential_1_thread"] = {
        "micro_f1": f1, "micro_f1_split_seeds_0_4": by_split, "embed_s": embed_s,
        "train_s": train_s, "pairs": pairs, "pairs_per_s": pairs / train_s}
    log(f"[quality] sequential, 1 thread: {record['sequential_1_thread']}")

    walks, eff = g.simulate_walks_device(10, WALK_LENGTH)
    profile_sgns(walks, eff, "quality sgns", out, num_nodes=g.num_nodes)
    log(json.dumps({"quality_profile": record}))



def multichip_rank(mesh, host, steps):
    """One rank of the multichip section: the profiled steps, replicated
    then edge-partitioned, each with its op table."""
    import torch

    from chip_smoke import WALK_LENGTH, mc_bench_config, mc_step_profile
    from pecanpy_tpu_torch.parallel import train

    res = {}
    for partition in ("replicated", "edge"):
        tr = train.MultichipTrainer(mesh, host, mc_bench_config(), WALK_LENGTH, 0.5, 2.0,
                                    partition=partition)
        tables = []
        res[partition] = mc_step_profile(tr, steps=steps, prof_out=tables)
        res[partition]["table"] = tables[0]
        del tr
        torch.cuda.empty_cache()
    return res


def profile_multichip(tmp, out):
    import json

    from chip_smoke import MEAN_DEGREE, NODES, build_bench_graph, mc_host_graph
    from pecanpy_tpu_torch.parallel import launch

    indptr, indices, data = build_bench_graph(NODES, MEAN_DEGREE)
    path = os.path.join(tmp, "bench_graph.csr.npz")
    np.savez(path, indptr=indptr, indices=indices, data=data)
    host = mc_host_graph(path)
    t0 = time.perf_counter()
    ranks = launch.spawn(multichip_rank, 2, (host, MULTICHIP_STEPS), device="cuda",
                         backend="gloo")
    log(f"[multichip] 2 gloo ranks on one card, {time.perf_counter() - t0:.1f} s")
    summary = {}
    for rank, res in enumerate(ranks):
        for partition, r in res.items():
            table = r.pop("table")
            out.write(f"== multichip rank {rank} {partition}: {MULTICHIP_STEPS} fused steps "
                      f"==\n{table}\n")
            r["body_ms"] = r["host_ms"] - r["collective_ms"]
            log(f"[multichip rank {rank} {partition}] {r['walks_per_step']} walks a step: "
                f"host {r['host_ms']:.2f} ms, device busy {r['device_ms']:.2f} ms, idle "
                f"share {r['idle_share']:.3f}; collectives {r['collective_ms']:.2f} ms "
                f"({r['collective_calls']:.0f} calls, {r['staged_bytes']:.0f} B host copies, "
                f"{r['staging_copy_ms']:.2f} ms device); step body "
                f"{r['body_ms']:.2f} ms")
            summary[f"rank{rank}_{partition}"] = r
    log(json.dumps({"multichip_profile": summary}))


# -- the benchmark's cells, traced from inside the port ---------------------

BENCH_DIR = os.path.join(REPO, "portbench")
CELL_SEED = 2**31 + 1515  # the set-up's graph; call i runs under CELL_SEED + 1 + i


def cell_setup(name):
    """Benchmark cell ``name`` (``portbench/``) set up on the card as a run
    sets it up (graph from ``CELL_SEED``, the CLI's reader, layout,
    warm-up): (cell, mode, entry, set-up diagnostics)."""
    import torch

    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    from harness import cells, runner

    cell = cells.resolve(name)
    diag = {}
    mode, entry, _, _ = runner.set_up(cell, CELL_SEED, torch.device("cuda:0"), diag)
    torch.cuda.synchronize()
    return cell, mode, entry, diag


def entry_job(entry):
    from harness.entries import EmbedEntry

    return "pecanpy.embed" if isinstance(entry, EmbedEntry) else "pecanpy.walks"


def log_job(rec, label):
    """A job record (``utils/trace.py``): its spans by total time, each with
    its count, time a count, waits, and its counters."""
    counters = {k: rec.counter(k) for k in [*rec.counters, *rec.device_counters]}
    log(f"[{label}] job {rec.name}: {rec.wall_ns / 1e9:.4f} s, counters {counters}")
    for name, t in sorted(rec.spans.items(), key=lambda kv: -kv[1].total_ns):
        log(f"    {name:36s} {t.count:7d} x {t.total_ns / 1e6 / t.count:10.4f} ms = "
            f"{t.total_ns / 1e9:9.4f} s; wait {t.wait_ns / 1e9:9.4f} s, dispatch "
            f"{t.dispatch_ns / 1e6 / t.count:10.4f} ms a count")


def span_cost(n=200_000):
    """Host ns of one span, at each level, on this machine's CPU."""
    from pecanpy_tpu_torch.utils import trace

    def per(make):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make("pecanpy.cost.span"):
                pass
        return (time.perf_counter_ns() - t0) / n

    free = per(trace.span)
    with trace.job("pecanpy.cost.job"):
        span, sync = per(trace.span), per(trace.sync)
    trace.enable()
    try:
        with trace.job("pecanpy.cost.job"):
            enabled = per(trace.span)
    finally:
        trace.disable()
        trace.reset()
    log(f"[trace cost] ns a span: outside a job {free:.0f}, in a job {span:.0f}, a sync "
        f"{sync:.0f}, enabled (log and record_function range) {enabled:.0f}")


def profile_cells(out, names):
    """Each cell's call traced from inside the port: the layout's phases,
    one call on the host clock and one under the profiler with tracing
    enabled (the idle gaps by port span), the call's spans and counters,
    and the enabled level's cost (calls in turns, tracing off and on)."""
    import torch

    from pecanpy_tpu_torch.utils import trace

    for name in names:
        cell, mode, entry, diag = cell_setup(name)
        log(f"[{name}] set-up {', '.join(f'{k} {v:.2f} s' for k, v in diag.items())}")
        log_job(trace.last_job("pecanpy.layout"), name)
        calls = iter(range(1, 100))
        log(f"[{name}] one call, top ops by device time:")
        host_s, busy_s = profiled(lambda: entry.call(CELL_SEED + next(calls)), name, out,
                                  top=12)
        log(f"[{name}] {host_s:.4f} s host clock; device busy {busy_s or 0:.4f} s under "
            f"the profiler, idle share {1 - (busy_s or 0) / host_s:.4f}")
        times = {False: [], True: []}
        for on in (False, True, True, False):
            if on:
                trace.enable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.call(CELL_SEED + next(calls))
            torch.cuda.synchronize()
            times[on].append(time.perf_counter() - t0)
            trace.disable()
            if not on:
                rec = trace.last_job(entry_job(entry))
        log(f"[{name}] enabled level: calls off {times[False]}, on {times[True]} s "
            f"(off, on, on, off); {trace.dropped()} spans dropped")
        trace.reset()
        log_job(rec, f"{name}, an untraced call")
        entry.release()
        del mode, entry
        torch.cuda.empty_cache()


def sync_census(names=None):
    """One call of each cell under ``torch.cuda.set_sync_debug_mode("warn")``:
    the synchronizing operations CUDA reports, by site, against the job's
    ``syncs`` counter and its sync spans."""
    import collections
    import traceback
    import warnings

    import torch

    from pecanpy_tpu_torch.utils import trace

    span_cost()
    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    from harness import cells

    for name in names or list(cells.all_cells()):
        _, mode, entry, _ = cell_setup(name)
        caught, stacks, calling = [], {}, []

        def keep(message, category, filename, lineno, file=None, line=None):
            # only the call's: switching the mode on once reports itself
            if not calling or "synchroniz" not in str(message):
                return
            site = f"{os.path.relpath(filename, REPO)}:{lineno}"
            caught.append(site)
            if not os.path.abspath(filename).startswith(REPO) and site not in stacks:
                stacks[site] = traceback.format_stack(limit=12)[:-1]

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            torch.cuda.set_sync_debug_mode("warn")
            calling.append(True)
            try:
                entry.call(CELL_SEED + 1)
            finally:
                calling.clear()
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rec = trace.last_job(entry_job(entry))
        sites = collections.Counter(caught)
        n = sum(sites.values())
        log(f"[census {name}] {n} synchronizing operations reported, the job's syncs "
            f"counter {rec.counter(trace.SYNCS)}: "
            f"{'equal' if n == rec.counter(trace.SYNCS) else 'NOT EQUAL'}")
        for site, k in sites.most_common():
            log(f"    {site:48s} {k:7d}")
        for site, stack in stacks.items():  # a site outside the port: who called it
            log(f"    {site} reached from:\n" + "".join(stack))
        log_job(rec, f"census {name}")
        entry.release()
        del mode, entry
        torch.cuda.empty_cache()


def precomp_table(seeds, path_out, cell=None, device="cuda:0"):
    """PreComp's table on the graph of ``cell`` (default
    ``uniform1m.precomp``), set up as a run sets it up, against the plain
    reference, and the law of its walks beside those of the table rounded
    to bfloat16 and of the q = 1 control, for each seed; a JSON line a
    seed is appended to ``path_out``."""
    import json

    import torch

    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    from harness import cells, check, entries, runner
    from pecanpy_tpu_torch.utils import trace
    from reference import precomp_table as ref_lib
    from reference import walklaw

    cell = cell or cells.resolve("uniform1m.precomp")
    cfg = cell.config
    dev = torch.device(device)
    os.makedirs(os.path.dirname(os.path.abspath(path_out)), exist_ok=True)
    for seed in seeds:
        diag = {}
        # the warm-up's first chunk builds the table: the job pecanpy.precomp
        mode, entry, _, (indptr, indices, data) = runner.set_up(cell, seed, dev, diag)
        job = trace.last_job("pecanpy.precomp")
        dg, table = mode.get_device_graph(), mode.edge_cdf
        row = dict(cell=cell.name, seed=seed, set_up=diag, edges=int(indices.size),
                   max_degree=int(np.diff(indptr).max()), dpad=dg.dpad,
                   table_shape=list(table.shape), table_bytes=job.counter("precomp.table_bytes"),
                   build_slices=job.counter("precomp.build_slices"), build_s=job.wall_ns / 1e9,
                   build_syncs=job.counter(trace.SYNCS))

        # -- the table and the first-order channel against the reference --
        t0 = time.perf_counter()
        ref = ref_lib.PrecompReference(indptr, indices, data, cfg["p"], cfg["q"], dev)
        atol = ref_lib.f32_cdf_atol(ref.max_degree)
        gap, pad_faults = ref_lib.table_gaps(ref.edge_rows, table)
        gap16, pad16 = ref_lib.table_gaps(ref.edge_rows, table.to(torch.bfloat16))
        first = dg.rows_cdf(dg.fused)
        gap1, pad1 = ref_lib.table_gaps(ref.node_rows, first)
        gap1_16, _ = ref_lib.table_gaps(ref.node_rows, first.to(torch.bfloat16))
        row.update(table_gap=gap, table_atol=atol, table_pad_faults=pad_faults,
                   table_ok=gap <= atol and pad_faults == 0,
                   bf16_table_gap=gap16, bf16_table_pad_faults=pad16,
                   bf16_table_fails=gap16 > atol or pad16 > 0,
                   first_gap=gap1, first_atol=ref_lib.F32_ROUNDED_ATOL, first_pad_faults=pad1,
                   first_ok=gap1 <= ref_lib.F32_ROUNDED_ATOL and pad1 == 0,
                   bf16_first_gap=gap1_16, reference_s=time.perf_counter() - t0)
        del ref, table, first

        # -- the law: a call at the configuration's q, one from the table
        # rounded to bfloat16, then the control's --
        g = walklaw.RefGraph(indptr, indices, data, dev)
        for label, q in (("program", cfg["q"]), ("bf16_table", cfg["q"]), ("control_q1", 1.0)):
            if label == "bf16_table":
                mode.edge_cdf = mode.edge_cdf.to(torch.bfloat16).to(torch.float32)
            elif q != mode.q:
                mode.q = q
                mode.preprocess_transition_probs()  # the table built again at q
            t0 = time.perf_counter()
            walks, eff = entry.call(runner.derived_seed(seed, 2, 0))
            entries.sync(dev)
            call_s = time.perf_counter() - t0
            numbers = check.walk_numbers(g, walks, eff, cfg, cell.traffic["check"]["law_steps"],
                                         runner.derived_seed(seed, 4))
            row[label] = dict(numbers, call_s=call_s, built_at_q=q)
            entry.release()
            del walks, eff
        log(f"[precomp-table] {json.dumps(row)}")
        with open(path_out, "a") as f:
            f.write(json.dumps(row) + "\n")
        mode._device_graph = mode.edge_cdf = None
        del mode, entry, dg, g
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
