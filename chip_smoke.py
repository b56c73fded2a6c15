#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: a CUDA device is required; prints its name, capability,
   ``nvidia-smi`` name and power limit, and the TF32 matmul setting;
2. build: compiles the CUDA kernels from ``pecanpy_tpu_torch/csrc`` into
   ``build/`` and prints the seconds it took;
3. kernel vs plain: the table applier (``ops/apply.py:apply_sorted_stream``)
   against its plain torch version on a [1M, 128] table at the SGNS
   stream sizes, f32 and bf16, to the bit, with both times (CUDA events,
   median of 20);
4. main path at full width: the 1M-node, mean-degree-16 weighted graph of
   ``bench.py``, read from a ``.csr.npz``, walked (p=0.5, q=2), then
   ``embed(dim=128, num_walks=1, walk_length=80, max_steps=50)`` with
   bf16 tables; the applier's launch count must rise by 2 per step;
   SGNS on a small block-model graph must recover its communities;
5. entry point: the CLI on ``demo/karate.edg`` twice, byte-identical;
6. the hub path at full width: the 1M-node Chung-Lu power-law graph of
   ``benchmarks/bench_powerlaw.py`` (exponent 2.2, mean degree 16),
   a. read from a ``.csr.npz`` into ``SparseOTF(p=0.5, q=2)``: hubs and
      the cdf channel;
   b. the two rejection-trial kernels (``ops/trialkernel.py``, on node
      ids) against their plain torch version on 32,768 edge lanes,
      trials = 2 with the return-edge atom, with and without
      ``force_ok``: bit for bit with the cdf channel, under
      ``NO_CDF_MISMATCH_SHARE`` without it (a column slice of the fused
      table); times (device time under ``torch.profiler``, mean of 20
      calls; the wrapper calls also by CUDA events, median of 20);
   c. ``simulate_walks_device(1, 80)`` through the queued engine: 2
      trial-kernel launches per round, every sampled step an edge, hub
      walk steps/s; then one dispatch under ``torch.profiler``: the
      round's device time;
   d. ``generate_walks_amortized`` on 32,768 starts;
   e. the second-order law on the card, both engines, undirected and
      directed: empirical transition frequencies against the exact law;
   f. ``embed(dim=128, num_walks=1, walk_length=80, max_steps=50)``; its
      last W_in and W_out streams: their longest segments, the segments
      longer than kernel 2.1's short pass takes, and kernel 2.1 on them
      (to the bit its plain version) beside the windowed kernel and
      ``index_add_`` by device time;
7. the remaining modes and the windowed applier:
   a. the windowed kernel (``ops/apply.py:apply_sorted_stream_windowed``)
      bit-equal to the applier of phase 3, that one bit-equal to its plain
      version, and the windowed kernel within its tolerances of its own
      plain version, on phase 3's streams, one with a hot row of
      ``HOT_ROW`` entries, one whose hot segment crosses the kernel's
      first block boundary and one of ``SHORT_ROWS`` rows (fewer than its
      blocks), f32 and bf16; each timed by CUDA events (median of 20) and
      by device time under ``torch.profiler`` (mean of 20), beside kernel
      2.1 and ``index_add_``;
   b. ``PreComp(p=0.5, q=2)`` on phase 4's graph: the per-edge CDF build,
      ``simulate_walks_device(1, 80)`` (every sampled step an edge), and
      ``embed(max_steps=50)`` with ``PECANPY_TPU_APPLY_V2`` on: 2 windowed
      launches per step, none of phase 3's kernel;
   c. PreComp's second-order law on a 40-node graph, its table rows and
      its on-the-fly fallback for nodes wider than the table;
   d. ``FirstOrderUnweighted`` and ``PreCompFirstOrder`` on phase 6's
      power-law graph (hub-aware draws; walks leave their hub starts), and
      their first-order laws on a small hub graph;
   e. ``Node2vecPlusPlus`` on a dense 2,000-node graph; the CLI's
      ``tocsr`` task, PreComp from the ``.csr.npz`` with the windowed
      applier (two runs byte-identical), and ``--task walks``;
   f. the block-model gate through PreComp with the windowed applier;
8. the quality protocol of ``benchmarks/bench_quality.py`` (the North
   star's hold) at its own size, through the entry points:
   a. ``utils/evaluate.py:overlapping_sbm`` (10,312 nodes, 39 overlapping
      communities, seed 1) written as a 3-column ``.edg`` and read back by
      the native C++ parser and by the Python parser, bit-equal;
   b. ``SparseOTF(random_state=0)`` (p = q = 1), ``embed(dim=128,
      num_walks=10, walk_length=80, window_size=10, epochs=1)`` with
      ``table_dtype="auto"`` (f32 here): kernel 2.1 launches twice a
      chunk-step and no other kernel launches; its walks follow the
      uniform first-order law within ``LAW_SIGMAS``; scored by the node2vec
      paper's protocol (one-vs-rest logistic regression on the card,
      top-k, micro-F1, half the nodes for training): at least
      ``QUALITY_GATE_BATCHED``;
   c. the random-embedding floor of the same protocol: below
      ``QUALITY_FLOOR_LIMIT``;
   d. ``embed(trainer="sequential")`` on the same mode with
      ``workers=0`` (hogwild over every host thread): at least
      ``QUALITY_GATE_SEQUENTIAL``;
   e. the hub tables of phase 6's graph from the native and the Python
      builder, timed once each: hash tables byte-equal, each hub's alias
      rows imply the same neighbour law within ``ALIAS_LAW_TOL``;
   and prints one ``{"quality": {...}}`` JSON line;
9. prints the kernels JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NODES = 1_000_000
MEAN_DEGREE = 16
DIM = 128
WALK_LENGTH = 80
WINDOW = 10
MAX_STEPS = 50
NEG_POOL = 32_768
TIMING_REPS = 20
BF16_MISMATCH_SHARE = 1e-4  # of touched elements; each at most 1 ulp off
HUB_LANES = 32_768  # walker lanes of the hub engines (the hub default)
TRIALS = 2
# without the cdf channel the kernel's warp prefix sum and torch.cumsum add
# in another order: on float weights a draw may land on the neighboring
# slot when u * total falls within a few ulps of a category boundary
NO_CDF_MISMATCH_SHARE = 1e-3  # of lanes
LAW_SIGMAS = 5.0  # per-frequency tolerance of the second-order law check
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
SECTOR = 32  # bytes: the least the memory system moves for one gather
HOT_ROW = 5_000  # entries of one id in phase 7a's hot-row stream
BOUNDARY_ROW = 2_000  # entries of the id that crosses 7a's first block boundary
SHORT_ROWS = 100  # rows of 7a's stream that is shorter than the windowed grid
PRECOMP_LAW_WIDTH = 8  # PreComp table width on phase 7c's 40-node law graph
# phase 8: the protocol of benchmarks/bench_quality.py (BlogCatalog's shape)
QUALITY_NODES = 10_312
QUALITY_COMMUNITIES = 39
QUALITY_MEAN_DEGREE = 64.0
QUALITY_GATE_BATCHED = 0.49  # the JAX package's f32 batched trainer: 0.5096
QUALITY_GATE_SEQUENTIAL = 0.52  # the JAX package's sequential reference: 0.541
QUALITY_FLOOR_LIMIT = 0.10  # the JAX package's random-embedding floor: 0.062
ALIAS_LAW_TOL = 1e-6


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_bench_graph(n, avg_deg, seed=0):
    """The random undirected weighted graph of ``bench.py:build_graph``."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    src = rng.integers(0, n, m, dtype=np.int64)
    dst = rng.integers(0, n, m, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    code = np.unique(u * n + v)
    u, v = code // n, code % n
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    w = (((lo * 2654435761 + hi) % 1000) / 1000.0 * 1.5 + 0.5).astype(np.float32)
    order = np.lexsort((v, u))
    u, v, w = u[order], v[order], w[order]
    deg = np.bincount(u, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, v, w


def sbm_graph(rng, blocks=4, per_block=40, p_in=0.25, p_out=0.01):
    """The block-model graph of ``tests/test_downstream.py:sbm_graph``."""
    n = blocks * per_block
    labels = np.repeat(np.arange(blocks), per_block)
    probs = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    upper = np.triu(rng.random((n, n)) < probs, k=1)
    adj = (upper | upper.T).astype(float)
    np.fill_diagonal(adj, 0.0)
    for i in np.where(adj.sum(1) == 0)[0]:
        j = int(rng.integers(0, per_block)) + (i // per_block) * per_block
        j = j if j != i else (j + 1) % per_block + (i // per_block) * per_block
        adj[i, j] = adj[j, i] = 1.0
    return adj, labels


def micro_f1_nearest_centroid(emb, labels, rng, train_frac=0.5):
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    order = rng.permutation(emb.shape[0])
    split = int(train_frac * emb.shape[0])
    train, test = order[:split], order[split:]
    centroids = np.stack(
        [emb[train][labels[train] == c].mean(0) for c in np.unique(labels)]
    )
    pred = np.argmax(emb[test] @ centroids.T, axis=1)
    return float((pred == labels[test]).mean())


def cuda_median_ms(fn, reps=TIMING_REPS):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def self_device_us(evt) -> float:
    """A ``torch.profiler`` event's own device time in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(fn, reps=TIMING_REPS):
    """Mean device time of one call of ``fn``: the summed time of the
    kernels it launches under ``torch.profiler``, without the host's
    time between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    # a profiler session now and then records no device activity at all
    # (seen on the card, in the third of four sessions of one run); it is run
    # again, and three empty ones in a row fail
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(self_device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
        log(f"[profiler] session {attempt + 1} recorded no device time; running it again")
    raise RuntimeError("torch.profiler recorded no device time in three sessions")


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps between two bf16 tensors
    (sign-magnitude bit patterns mapped onto one ordered integer line)."""
    import torch

    def ordered(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def assert_bit_equal(label, got, want):
    """Raise unless two tables of one type agree to the bit."""
    import torch

    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    n_diff = int((got.view(bits) != want.view(bits)).sum())
    if n_diff:
        raise AssertionError(f"{label}: {n_diff} of {got.numel()} elements differ")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise RuntimeError("the kernels are built for sm_90a (Hopper, capability 9.0)")
    smi = nvidia_smi_line()
    log(f"[1 device] nvidia-smi name, power.limit: {smi}")
    log(f"[1 device] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return name, smi


def phase_build():
    from pecanpy_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.load()
    log(f"[2 build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"from {_kernels.CSRC_DIR.relative_to(REPO)} into "
        f"{_kernels.BUILD_DIR.relative_to(REPO)}")


def make_stream(r, n, d, seed):
    """Sorted ids (random plus a few hot ids repeated hundreds of times)
    and an f32 payload of SGD-sized rows."""
    import torch

    gen = np.random.default_rng(seed)
    hot = gen.choice(n, 8, replace=False)
    ids = np.concatenate([gen.integers(0, n, r - 8 * 300), np.repeat(hot, 300)])
    ids_s = torch.from_numpy(np.sort(ids).astype(np.int32)).cuda()
    upd_s = (torch.randn(r, d, device="cuda") * 1e-3).contiguous()
    return ids_s, upd_s


def compare_with_plain(label, t_k, t_p, table0, ids_s):
    """Hold an applier kernel's table against its plain version's: rows no
    id names bit-equal, touched rows moved and within the tolerance (f32
    allclose rtol=1e-5 atol=1e-6; bf16 at most ``BF16_MISMATCH_SHARE`` of
    touched elements differ, each by 1 ulp). Returns (max_abs_err, the
    check as text, the touched-row mask)."""
    import torch

    touched = torch.zeros(t_k.shape[0], dtype=torch.bool, device=t_k.device)
    touched[ids_s.long()] = True
    if not torch.equal(t_k[~touched], table0[~touched]):
        raise AssertionError(f"{label}: untouched rows changed")
    err = float((t_k.float() - t_p.float()).abs().max())
    if t_k.dtype == torch.float32:
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
        check = "allclose rtol=1e-5 atol=1e-6"
    else:
        # kernel and plain share the rounding bits: they may differ only
        # where the two f32 sums straddle a rounding boundary
        ulps = bf16_ulps(t_k[touched], t_p[touched])
        n_diff, max_ulps = int((ulps > 0).sum()), int(ulps.max())
        if max_ulps > 1 or n_diff > BF16_MISMATCH_SHARE * ulps.numel():
            raise AssertionError(
                f"{label}: {n_diff} of {ulps.numel()} touched elements differ from "
                f"plain, up to {max_ulps} ulps (allowed: {BF16_MISMATCH_SHARE:g} of "
                "them, 1 ulp)")
        check = f"{n_diff} of {ulps.numel()} touched elements differ, max {max_ulps} bf16 ulp"
    if not bool(torch.ne(t_k[touched], table0[touched]).any()):
        raise AssertionError(f"{label}: no touched row moved")
    return err, check, touched


def phase_kernel_vs_plain():
    import torch

    from pecanpy_tpu_torch.ops import apply as apply_lib

    n, d = NODES, DIM
    r_in = 1235 * (WALK_LENGTH + 1)  # W_in stream: batch walks x tokens
    r_out = r_in + NEG_POOL  # W_out: plus the negative pool slots
    base = (torch.rand(n, d, device="cuda") - 0.5) / d
    results = {}
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        table0 = base.to(dtype)
        for r in (r_in, r_out):
            ids_s, upd_s = make_stream(r, n, d, seed=r)
            seed = 12345
            t_k = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, seed)
            t_p = apply_lib.apply_sorted_stream_plain(table0.clone(), ids_s, upd_s, seed)
            torch.cuda.synchronize()
            err, check, touched = compare_with_plain(f"{dtype} R={r}", t_k, t_p, table0, ids_s)
            assert_bit_equal(f"kernel 2.1 {dtype} R={r} against its plain version", t_k, t_p)
            table = table0.clone()
            ms = cuda_median_ms(
                lambda: apply_lib.apply_sorted_stream(table, ids_s, upd_s, seed))
            plain_ms = cuda_median_ms(
                lambda: apply_lib.apply_sorted_stream_plain(table, ids_s, upd_s, seed))
            # the library yardstick: one index_add_ of the payload in the
            # table's type (round to nearest, not stochastic, in bf16)
            ids_l, upd_l = ids_s.long(), upd_s.to(dtype)
            library_ms = cuda_median_ms(lambda: table.index_add_(0, ids_l, upd_l, alpha=-1))
            n_touched = int(touched.sum())
            # bound: the ids and the f32 payload read once, each touched
            # table row read and written once
            nbytes = r * 4 + r * d * 4 + 2 * n_touched * d * table.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            name = str(dtype).replace("torch.", "")
            log(f"[3 kernel] {name} R={r}: bit-equal to plain, max_abs_err {err:.3e} "
                f"({check}), untouched rows bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"index_add_ {library_ms:.4f} ms; {n_touched} touched rows, "
                f"{nbytes / 1e6:.2f} MB moved at least: bound {bound_ms:.4f} ms")
            results[(name, r)] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                      library_ms=library_ms, bound_ms=bound_ms)
            max_err = max(max_err, err)
            del t_k, t_p, table, ids_l, upd_l
    del base
    torch.cuda.empty_cache()
    return results, max_err


def check_walks_follow_edges(walks, eff, indptr, indices, n, sample=10_000):
    rows = np.random.default_rng(0).choice(walks.shape[0], sample, replace=False)
    w, e = walks[rows].astype(np.int64), eff[rows]
    a, b = w[:, :-1], w[:, 1:]
    valid = np.arange(a.shape[1])[None, :] < (e[:, None] - 1)
    keys = a[valid] * n + b[valid]
    row_of_edge = np.repeat(np.arange(n), np.diff(indptr))
    edge_keys = row_of_edge * n + indices.astype(np.int64)  # sorted (CSR)
    pos = np.clip(np.searchsorted(edge_keys, keys), 0, edge_keys.size - 1)
    bad = int((edge_keys[pos] != keys).sum())
    if bad:
        raise AssertionError(f"{bad} of {keys.size} sampled walk steps are not edges")
    return keys.size


def phase_main_path(tmp):
    import torch

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.ops import apply as apply_lib

    t0 = time.perf_counter()
    indptr, indices, data = build_bench_graph(NODES, MEAN_DEGREE)
    path = os.path.join(tmp, "bench_graph.csr.npz")
    np.savez(path, indptr=indptr, indices=indices, data=data)
    log(f"[4 main] graph: {NODES} nodes, {indices.size} directed edges, max "
        f"degree {int(np.diff(indptr).max())}; built + saved in "
        f"{time.perf_counter() - t0:.1f} s")

    g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=0, device="cuda")
    g.read_npz(path, weighted=True, implicit_ids=True)
    t0 = time.perf_counter()
    g.preprocess_transition_probs()
    torch.cuda.synchronize()
    dg = g.get_device_graph()
    log(f"[4 main] fused layout {tuple(dg.fused.shape)} f32 "
        f"({dg.fused.numel() * 4 / 1e6:.0f} MB) built in {time.perf_counter() - t0:.2f} s")

    g.simulate_walks_device(1, 8)  # warm-up at a short length
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walks, eff = g.simulate_walks_device(1, WALK_LENGTH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    walks_np, eff_np = walks.cpu().numpy(), eff.cpu().numpy()
    steps = int((eff_np - 1).sum())
    log(f"[4 main] walks {tuple(walks.shape)} ({walks.numel() * 4 / 1e6:.0f} MB) in "
        f"{dt:.3f} s: {steps / dt:.4e} effective walk steps/s")
    n_checked = check_walks_follow_edges(walks_np, eff_np, indptr, indices, NODES)
    log(f"[4 main] sampled walks: all {n_checked} steps are edges")

    config = sgns.SGNSConfig(dim=DIM, window=WINDOW, seed=0)
    dtype = sgns.resolve_table_dtype(config, NODES, "cuda")
    if dtype != torch.bfloat16:
        raise AssertionError(f"tables resolved to {dtype}, expected bfloat16")
    torch.cuda.reset_peak_memory_stats()
    apply_lib.apply_sorted_stream.launches = 0
    emb = g.embed(dim=DIM, num_walks=1, walk_length=WALK_LENGTH,
                  window_size=WINDOW, max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    launches = apply_lib.apply_sorted_stream.launches
    log(f"[4 main] embed: applier launches {launches} in {MAX_STEPS} chunk-steps; "
        f"tables 2 x {NODES * DIM * 2 / 1e6:.0f} MB bf16; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if launches != 2 * MAX_STEPS:
        raise AssertionError(f"applier launched {launches} times, expected {2 * MAX_STEPS}")
    if emb.shape != (NODES, DIM) or emb.dtype != np.float32:
        raise AssertionError(f"embeddings {emb.shape} {emb.dtype}")
    if not np.isfinite(emb).all():
        raise AssertionError("non-finite embeddings")
    init = sgns.init_tables(0, NODES, DIM, dtype, "cuda")[0].float().cpu().numpy()
    moved = int((emb != init).any(axis=1).sum())
    if moved == 0:
        raise AssertionError("embeddings equal their initialization")
    log(f"[4 main] embeddings {emb.shape} {emb.dtype}, finite; {moved} rows moved from init")

    # time the trainer call embed makes, on the walks measured above
    chunk = sgns.resolve_batch_walks(config, NODES, WALK_LENGTH + 1)
    tokens = float(eff_np[: chunk * MAX_STEPS].sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgns.train(walks, eff, NODES, config, max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[4 main] sgns.train: {MAX_STEPS} chunk-steps of {chunk} walks, "
        f"{tokens:.0f} tokens in {dt:.3f} s: {tokens / dt:.4e} tokens/s "
        f"({1e3 * dt / MAX_STEPS:.2f} ms per chunk-step incl. setup and table fetch)")
    del walks, eff, g, dg
    torch.cuda.empty_cache()

    # quality on a small input: the JAX suite's block-model gate
    rng = np.random.default_rng(0)
    adj, labels = sbm_graph(rng)
    gs = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(adj.shape[0])],
                                    random_state=0, device="cuda")
    emb_s = gs.embed(dim=32, num_walks=8, walk_length=30, window_size=5, epochs=3)
    f1 = micro_f1_nearest_centroid(emb_s, labels, rng)
    log(f"[4 main] block-model graph (160 nodes): micro-F1 {f1:.4f} (gate 0.9)")
    if f1 < 0.9:
        raise AssertionError(f"block-model micro-F1 {f1:.4f} below 0.9")
    return launches


def phase_cli(tmp):
    outs = []
    for i in range(2):
        out = os.path.join(tmp, f"k{i}.emb")
        subprocess.run(
            [sys.executable, "-m", "pecanpy_tpu_torch.cli", "--input",
             os.path.join(REPO, "demo", "karate.edg"), "--output", out,
             "--dimensions", "16", "--walk-length", "10", "--num-walks", "3",
             "--window-size", "4", "--p", "0.5", "--q", "2", "--random_state", "0"],
            cwd=REPO, check=True, timeout=600,
        )
        with open(out, "rb") as f:
            outs.append(f.read())
    header = outs[0].split(b"\n", 1)[0]
    if header != b"34 16":
        raise AssertionError(f"CLI header {header!r}, expected b'34 16'")
    if outs[0] != outs[1]:
        raise AssertionError("two CLI runs with one seed wrote different files")
    log("[5 cli] karate: header '34 16', two runs byte-identical")


def build_powerlaw_graph(n, avg_deg=16, exponent=2.2, seed=0, directed=False):
    """The Chung-Lu heavy-tail graph of
    ``benchmarks/bench_powerlaw.py:build_powerlaw_graph``, as a sorted CSR."""
    rng = np.random.default_rng(seed)
    w = (1.0 - rng.random(n)) ** (-1.0 / (exponent - 1.0))
    prob = w / w.sum()
    m = n * avg_deg // 2
    cdf = np.cumsum(prob)
    src = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    dst = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if directed:
        u, v = src, dst
    else:
        u = np.concatenate([src, dst])
        v = np.concatenate([dst, src])
    code = np.unique(u * n + v)
    u, v = code // n, code % n
    if directed:
        wgt = (((u * 2654435761 + v) % 1000) / 1000.0 * 1.5 + 0.5).astype(np.float32)
    else:
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        wgt = (((lo * 2654435761 + hi) % 1000) / 1000.0 * 1.5 + 0.5).astype(np.float32)
    deg = np.bincount(u, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, v.astype(np.int64), wgt


def node2vec_probs(adj, cur, prev, p, q):
    """The exact node2vec law over cur's neighbors (``tests/oracle.py``)."""
    nbr_mask = adj[cur] != 0
    w = adj[cur].astype(np.float64).copy()
    out = nbr_mask & (adj[prev] == 0)
    out[prev] = False
    w[out] /= q
    w[prev] /= p
    w = w[nbr_mask]
    return w / w.sum()


def second_order_worst(walks, adj, p, q, min_count=400):
    """Empirical (prev, cur) -> next frequencies of ``walks`` against the
    exact node2vec law: (pairs checked, worst deviation in binomial sigma)."""
    n = adj.shape[0]
    trip = np.concatenate([walks[:, j : j + 3] for j in range(walks.shape[1] - 2)])
    key = (trip[:, 0] * n + trip[:, 1]) * n + trip[:, 2]
    counts = np.bincount(key, minlength=n ** 3).reshape(n, n, n)
    checked, worst = 0, 0.0
    for pv in range(n):
        for cu in np.nonzero(adj[pv])[0]:
            tot = counts[pv, cu].sum()
            if tot < min_count:
                continue
            freq = counts[pv, cu][np.nonzero(adj[cu])[0]] / tot
            dev = np.abs(freq - node2vec_probs(adj, cu, pv, p, q)).max()
            worst = max(worst, dev / np.sqrt(0.25 / tot))
            checked += 1
    return checked, worst


def first_order_worst(walks, eff, adj, probs, min_count=400):
    """Empirical cur -> next frequencies against ``probs(cur)`` over cur's
    neighbors: (nodes checked, worst deviation in binomial sigma)."""
    n = adj.shape[0]
    valid = np.arange(walks.shape[1] - 1)[None, :] < (eff[:, None] - 1)
    key = walks[:, :-1][valid].astype(np.int64) * n + walks[:, 1:][valid]
    counts = np.bincount(key, minlength=n * n).reshape(n, n)
    checked, worst = 0, 0.0
    for cu in range(n):
        tot = counts[cu].sum()
        if tot < min_count:
            continue
        freq = counts[cu][np.nonzero(adj[cu])[0]] / tot
        worst = max(worst, np.abs(freq - probs(cu)).max() / np.sqrt(0.25 / tot))
        checked += 1
    return checked, worst


def search_sectors(deg):
    """32-byte sectors a binary search over ``deg`` sorted 4-byte entries
    touches: about log2 of the sector count to find the sector, plus it."""
    import torch

    n_sec = torch.clamp((deg + 7) // 8, min=1).double()
    return torch.ceil(torch.log2(n_sec)) + 1


def trial_bytes(dg, draws, prev, cur, x, wx, p, q, alpha_np, theta):
    """Least bytes each trial kernel must move for this run's lanes (the
    cdf channel, the atom on), from each row's real degree, in 32-byte
    sectors for the gathers:

    trial_propose: per lane its cur id, the sector of its degree and the
    head sector of the cur row (the hub marker, a hub's alias base); a
    capped row adds the sector of its cdf total and, per trial whose atom
    does not fire, a binary search over its cdf entries and the sectors of
    the picked wgt and nbr slots (nbr beyond the head sector); a hub row
    adds one alias slot per such trial.
    trial_accept: per lane its prev id, the sector of its degree and the
    head sector of the prev row (a hub's hash meta); per trial that still
    decides the outcome (no earlier trial accepted, x != prev), a hub row
    probes one bucket's keys, a capped row searches its sorted nbr entries
    (or scans them, if fewer sectors).
    Both: the per-lane draws, atom inputs and outputs, read or written
    once. Returns (propose bytes, accept bytes)."""
    import torch

    from pecanpy_tpu_torch.ops import rejection

    s = SECTOR
    trials, b = draws.kk.shape
    per_trial = draws.trials()
    cur_rows, prev_rows = dg.gather_rows(cur), dg.gather_rows(prev)
    hub_c, hub_p = dg.rows_is_hub(cur_rows), dg.rows_is_hub(prev_rows)
    deg_c, deg_p = dg.rows_degree(cur_rows), dg.rows_degree(prev_rows)

    cdf = dg.rows_cdf(cur_rows)
    pick = torch.stack([(cdf < (d.u_small * cdf[:, -1])[:, None]).sum(1) for d in per_trial])
    pick = torch.clamp(pick, max=dg.dpad - 1)
    no_atom = torch.stack([d.u_atom >= theta for d in per_trial])
    capped_t = search_sectors(deg_c)[None] + 1 + (pick >= 8)
    row_t = torch.where(hub_c[None], 1.0, capped_t) * no_atom
    # head sector of each row, a capped row's cdf total, the degree sector
    propose_rows = s * (float(row_t.sum()) + b + float((~hub_c).sum()) + b)
    propose = propose_rows + b * 4 + b * (trials * 16 + 12) + b * trials * 8

    oks = torch.stack([
        rejection._accept_trial(dg, d, x[t], wx[t], prev, None, prev_rows, p, q,
                                False, alpha_np, True)
        for t, d in enumerate(per_trial)])
    earlier = torch.cumsum(oks.to(torch.int32), 0) - oks.to(torch.int32)
    decides = ((earlier == 0) & (x != prev[None])).sum(0).double()
    n_sec_p = torch.clamp((deg_p + 7) // 8, min=1).double()
    capped_p = torch.clamp(torch.minimum(n_sec_p, decides * search_sectors(deg_p)), min=1)
    # plus the degree sector of each lane
    accept_rows = s * (float(torch.where(hub_p, 1 + decides, capped_p).sum()) + b)
    accept = accept_rows + b * trials * 12 + b * 4 + b * 9
    return propose, accept


def hub_trial_lanes(indptr, indices, dg):
    """Phase 6b's lanes: ``HUB_LANES`` random edges prev -> cur of the
    power-law graph, with the round's draws (``TRIALS``), the atom's
    (theta, wp) at p = 0.5, q = 2 and a ``force_ok`` mask on a quarter of
    them. Returns a dict of them and (p, q, alpha_np)."""
    import torch

    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.ops import rejection

    gen = np.random.default_rng(1)
    e = gen.integers(0, indices.size, HUB_LANES)
    cur = torch.from_numpy((np.searchsorted(indptr, e, side="right") - 1).astype(np.int32))
    prev = torch.from_numpy(indices[e].astype(np.int32))  # undirected: an edge prev -> cur
    cur, prev = cur.cuda(), prev.cuda()
    cur_rows = dg.gather_rows(cur)
    p, q = 0.5, 2.0
    alpha_np = max(1.0, 1.0 / q)
    _, wp = rejection.membership(dg, prev, cur_rows)
    theta = engine._theta_from(dg, wp, cur_rows, 1.0 / p - alpha_np, alpha_np)
    draws = engine.TrialDrawStream(0, 0, TRIALS, "cuda")(0, dg.rows_degree(cur_rows))
    force_ok = torch.rand(HUB_LANES, device="cuda") < 0.25
    lanes = dict(cur=cur, prev=prev, theta=theta, wp=wp, kk=draws.kk, u=draws.u,
                 force_ok=force_ok)
    return lanes, (p, q, alpha_np)


def phase_hub_path(tmp):
    import torch

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.models import engine, sgns
    from pecanpy_tpu_torch.ops import apply as apply_lib
    from pecanpy_tpu_torch.ops import rejection, trialkernel
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    # -- a. the graph and its hub layout ---------------------------------
    t0 = time.perf_counter()
    indptr, indices, data = build_powerlaw_graph(NODES)
    path = os.path.join(tmp, "powerlaw_graph.csr.npz")
    np.savez(path, indptr=indptr, indices=indices, data=data)
    deg = np.diff(indptr)
    log(f"[6a hub] Chung-Lu graph: {NODES} nodes, {indices.size} directed edges, "
        f"max degree {int(deg.max())}, {int((deg == 0).sum())} isolated nodes; built "
        f"+ saved in {time.perf_counter() - t0:.1f} s")
    g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=0, device="cuda")
    g.read_npz(path, weighted=True, implicit_ids=True)
    t0 = time.perf_counter()
    g.preprocess_transition_probs()
    torch.cuda.synchronize()
    dg = g.get_device_graph()
    if not dg.has_hubs or "cdf" not in dg.channels:
        raise AssertionError(f"hub layout expected: has_hubs {dg.has_hubs}, "
                             f"channels {dg.channels}")
    n_hubs = int((deg > g.degree_cap).sum())
    log(f"[6a hub] layout in {time.perf_counter() - t0:.2f} s: {n_hubs} hubs above "
        f"degree_cap {g.degree_cap} (hub_frac {dg.hub_frac}); fused "
        f"{tuple(dg.fused.shape)} channels {dg.channels} "
        f"{dg.fused.numel() * 4 / 1e6:.0f} MB, edge_pack {dg.edge_pack.numel() * 4 / 1e6:.0f} MB, "
        f"hbuckets {dg.hbuckets.numel() * 4 / 1e6:.0f} MB")

    # -- b. trial kernels against their plain version ---------------------
    lanes, (p, q, alpha_np) = hub_trial_lanes(indptr, indices, dg)
    cur, prev, theta, wp, force_ok = (
        lanes[k] for k in ("cur", "prev", "theta", "wp", "force_ok"))
    draws = rejection.RoundDraws(lanes["kk"], lanes["u"])
    hub_c = int(dg.rows_is_hub(dg.gather_rows(cur)).sum())
    hub_p = int(dg.rows_is_hub(dg.gather_rows(prev)).sum())
    if min(hub_c, hub_p) < HUB_LANES // 4:
        raise AssertionError(f"hub lanes: {hub_c} cur, {hub_p} prev of {HUB_LANES}")

    def block(dg_, use_cdf, force, kernel):
        """The trial block through the kernels, or its plain version."""
        if kernel:
            return trialkernel.trial_block_fused(
                dg_, draws, prev, cur, p, q, alpha_np, theta, wp,
                use_cdf=use_cdf, force_ok=force)
        return rejection._trial_block(
            dg_, draws.trials(), prev, dg_.gather_rows(cur), dg_.gather_rows(prev), p, q,
            False, alpha_np, theta, wp, use_cdf=use_cdf, force_ok=force)

    def n_differ(got, want):
        """Lanes where any of (chosen, got, chosen_w) differs."""
        return int(torch.stack([a != b for a, b in zip(got, want)]).any(0).sum())

    for force in (None, force_ok):
        got = block(dg, True, force, True)
        want = block(dg, True, force, False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"cdf channel, force_ok {force is not None}: "
                                 f"{n_differ(got, want)} lanes differ from plain")
        log(f"[6b trial] cdf channel, force_ok {force is not None}: chosen, got, "
            f"chosen_w bit-equal to plain on {HUB_LANES} lanes ({hub_c} hub cur, "
            f"{hub_p} hub prev); accepted {int(got[1].sum())}")
    # without the cdf channel: the first two channels of the same rows, a
    # column slice of the table that the kernels read with its row stride
    dg_nc = dataclasses.replace(dg, fused=dg.fused[:, : 2 * dg.dpad], channels=("nbr", "wgt"))
    got = block(dg_nc, False, None, True)
    want = block(dg_nc, False, None, False)
    diff = n_differ(got, want)
    if diff > NO_CDF_MISMATCH_SHARE * HUB_LANES:
        raise AssertionError(f"no cdf channel: {diff} of {HUB_LANES} lanes differ")
    log(f"[6b trial] no cdf channel: {diff} of {HUB_LANES} lanes differ from plain "
        f"(allowed {NO_CDF_MISMATCH_SHARE:g} of them: prefix-sum order)")

    x, wx = trialkernel.trial_propose(dg, draws, prev, cur, theta, wp, True)
    x_p, wx_p = trialkernel.trial_propose_plain(dg, draws, prev, cur, theta, wp, True)
    acc = trialkernel.trial_accept(dg, draws, x, wx, prev, p, q, alpha_np, True)
    acc_p = trialkernel.trial_accept_plain(dg, draws, x, wx, prev, p, q, alpha_np, True)
    torch.cuda.synchronize()
    err_propose = max(float((x - x_p).abs().max()), float((wx - wx_p).abs().max()))
    err_accept = max(float((a.float() - b.float()).abs().max()) for a, b in zip(acc, acc_p))
    if err_propose or err_accept:
        raise AssertionError(f"kernel halves differ: {err_propose}, {err_accept}")
    calls = {
        "trial_propose": (
            lambda: trialkernel.trial_propose(dg, draws, prev, cur, theta, wp, True),
            lambda: trialkernel.trial_propose_plain(dg, draws, prev, cur, theta, wp, True)),
        "trial_accept": (
            lambda: trialkernel.trial_accept(dg, draws, x, wx, prev, p, q, alpha_np, True),
            lambda: trialkernel.trial_accept_plain(
                dg, draws, x, wx, prev, p, q, alpha_np, True)),
    }
    block_ms = cuda_median_ms(lambda: block(dg, True, None, True))
    block_plain_ms = cuda_median_ms(lambda: block(dg, True, None, False))
    nbytes = dict(zip(("trial_propose", "trial_accept"), trial_bytes(
        dg, draws, prev, cur, x, wx, p, q, alpha_np, theta)))
    results = {}
    for name, (kernel_fn, plain_fn) in calls.items():
        ms, plain_ms = device_ms(kernel_fn), device_ms(plain_fn)
        wrapper_ms, plain_wall_ms = cuda_median_ms(kernel_fn), cuda_median_ms(plain_fn)
        bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             max_abs_err=err_propose if name == "trial_propose" else err_accept)
        log(f"[6b trial] {name}: device time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"CUDA events over the call: wrapper {wrapper_ms:.4f} ms, plain "
            f"{plain_wall_ms:.4f} ms; {nbytes[name] / 1e6:.3f} MB at least: bound "
            f"{bound_ms:.5f} ms")
    log(f"[6b trial] whole trial block ({TRIALS} trials, {HUB_LANES} lanes): kernels "
        f"{block_ms:.4f} ms, plain {block_plain_ms:.4f} ms")
    del dg_nc, lanes, cur, prev

    # -- c. the queued engine over every start ----------------------------
    rounds = []
    queued = engine.generate_walks_queued

    def counted(*args, **kwargs):
        walks, eff, t = queued(*args, return_rounds=True, **kwargs)
        rounds.append(t)
        return walks, eff

    engine.generate_walks_queued = counted
    try:
        g.simulate_walks_device(1, 8)  # warm-up at a short length
        rounds.clear()
        torch.cuda.synchronize()
        trialkernel.trial_propose.launches = trialkernel.trial_accept.launches = 0
        t0 = time.perf_counter()
        walks, eff = g.simulate_walks_device(1, WALK_LENGTH)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        engine.generate_walks_queued = queued
    launches = trialkernel.trial_propose.launches + trialkernel.trial_accept.launches
    walks_np, eff_np = walks.cpu().numpy(), eff.cpu().numpy()
    steps = int((eff_np - 1).sum())
    per = g._resolved_walker_batch() * g._walk_queue_factor()
    log(f"[6c queued] walks {tuple(walks.shape)} in {dt:.3f} s: {steps / dt:.4e} "
        f"effective walk steps/s; {len(rounds)} dispatches of {per} walks on "
        f"{g._resolved_walker_batch()} lanes, rounds {rounds} ({sum(rounds)} in all); "
        f"trial-kernel launches {launches}")
    if launches != 2 * sum(rounds) or not rounds:
        raise AssertionError(f"{launches} trial-kernel launches in {sum(rounds)} rounds")
    if (eff_np == 1).sum() < (deg == 0).sum():
        raise AssertionError("isolated starts must stop at once")
    n_checked = check_walks_follow_edges(walks_np, eff_np, indptr, indices, NODES)
    log(f"[6c queued] sampled walks: all {n_checked} steps are edges; "
        f"{int((eff_np == 1).sum())} walks stopped at their start")
    del walks, eff
    # the round's device time: one dispatch of the engine under the profiler
    starts = torch.from_numpy(g._start_nodes(1)[:per]).cuda()
    one = {}

    def dispatch():
        one["rounds"] = queued(
            dg, starts, engine.TrialDrawStream(0, 0, TRIALS, "cuda"), WALK_LENGTH, p, q,
            False, lanes=HUB_LANES, return_rounds=True)[2]

    busy_ms = device_ms(dispatch, reps=1)
    log(f"[6c queued] one dispatch of {per} walks: {one['rounds']} rounds, device busy "
        f"{busy_ms / one['rounds']:.4f} ms per round under the profiler")

    # -- d. the per-batch amortized engine --------------------------------
    gen = np.random.default_rng(2)
    start = torch.from_numpy(gen.integers(0, NODES, HUB_LANES).astype(np.int32)).cuda()
    before = trialkernel.trial_propose.launches
    t0 = time.perf_counter()
    walks, eff, n_rounds = engine.generate_walks_amortized(
        dg, start, engine.TrialDrawStream(0, 1, TRIALS, "cuda"), WALK_LENGTH, p, q,
        False, return_rounds=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    a_launches = trialkernel.trial_propose.launches - before
    walks_np, eff_np = walks.cpu().numpy(), eff.cpu().numpy()
    n_checked = check_walks_follow_edges(walks_np, eff_np, indptr, indices, NODES, 2000)
    log(f"[6d amortized] {HUB_LANES} walks in {n_rounds} rounds, {dt:.3f} s "
        f"({float((eff_np - 1).sum()) / dt:.4e} steps/s); trial_propose launches "
        f"{a_launches}; all {n_checked} sampled steps are edges")
    if a_launches != n_rounds or n_rounds == 0:
        raise AssertionError(f"{a_launches} launches in {n_rounds} rounds")
    del walks, eff

    # -- e. the second-order law on the card ------------------------------
    law_rng = np.random.default_rng(3)
    for directed in (False, True):
        n = 40
        adj = (law_rng.random((n, n)) < 0.25) * law_rng.uniform(0.2, 3.0, (n, n))
        np.fill_diagonal(adj, 0.0)
        if not directed:
            adj = np.triu(adj) + np.triu(adj, 1).T
        for i in np.nonzero(adj.sum(1) == 0)[0]:
            adj[i, (i + 1) % n] = 1.5
        small = device_csr_from_dense(adj, degree_cap=8, with_cdf=True, device="cuda")
        if not small.has_hubs or small.symmetric == directed:
            raise AssertionError("law graph: hubs and symmetry as built")
        starts = torch.arange(n, dtype=torch.int32, device="cuda").repeat(2000)
        for name in ("queued", "amortized"):
            draws_l = engine.TrialDrawStream(7, int(directed), TRIALS, "cuda")
            if name == "queued":
                w_l, e_l = engine.generate_walks_queued(
                    small, starts, draws_l, 6, p, q, False, lanes=4096)
            else:
                w_l, e_l = engine.generate_walks_amortized(
                    small, starts, draws_l, 6, p, q, False)
            w_l, e_l = w_l.cpu().numpy(), e_l.cpu().numpy()
            if (e_l != 7).any():
                raise AssertionError("every law-graph node has out-edges")
            checked, worst = second_order_worst(w_l, adj, p, q)
            if checked < 50 or worst > LAW_SIGMAS:
                raise AssertionError(f"law, {name}, directed {directed}: {checked} "
                                     f"(prev, cur) pairs, worst {worst:.2f} sigma")
            log(f"[6e law] {name}, {'directed' if directed else 'undirected'}: "
                f"{checked} (prev, cur) pairs, worst frequency {worst:.2f} binomial "
                f"sigma (limit {LAW_SIGMAS})")

    # -- f. embed on the hub graph: the hub path's main path --------------
    config = sgns.SGNSConfig(dim=DIM, window=WINDOW, seed=0)
    # keep the last W_in and W_out streams that reach the applier: each
    # chunk-step updates W_in, then W_out
    streams, route = [], apply_lib._cuda_applier

    def recording_route(table):
        applier = route(table)

        def record(table, ids_s, upd_s, seed):
            streams.append((ids_s, upd_s, seed))
            del streams[:-2]
            return applier(table, ids_s, upd_s, seed)
        return record

    apply_lib._cuda_applier = recording_route
    try:
        apply_lib.apply_sorted_stream.launches = 0
        trialkernel.trial_propose.launches = trialkernel.trial_accept.launches = 0
        emb = g.embed(dim=DIM, num_walks=1, walk_length=WALK_LENGTH,
                      window_size=WINDOW, max_steps=MAX_STEPS)
        torch.cuda.synchronize()
    finally:
        apply_lib._cuda_applier = route
    launches = {
        "apply_sorted_stream": apply_lib.apply_sorted_stream.launches,
        "trial_propose": trialkernel.trial_propose.launches,
        "trial_accept": trialkernel.trial_accept.launches,
    }
    log(f"[6f embed] launches {launches} in {MAX_STEPS} chunk-steps")
    if launches["apply_sorted_stream"] != 2 * MAX_STEPS or not launches["trial_propose"]:
        raise AssertionError(f"launches {launches}")
    if launches["trial_propose"] != launches["trial_accept"]:
        raise AssertionError("trial kernels launched unequal times")
    if emb.shape != (NODES, DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    dtype = sgns.resolve_table_dtype(config, NODES, "cuda")
    init = sgns.init_tables(0, NODES, DIM, dtype, "cuda")[0].float().cpu().numpy()
    moved = int((emb != init).any(axis=1).sum())
    if moved == 0:
        raise AssertionError("embeddings equal their initialization")
    log(f"[6f embed] embeddings {emb.shape} {emb.dtype}, finite; {moved} rows moved")
    del g, dg
    hub_streams(dict(zip(("W_in", "W_out"), streams)), dtype)
    torch.cuda.empty_cache()
    return results, launches


def hub_streams(streams, dtype):
    """6f: the segments of the hub path's last SGNS streams, and kernel 2.1
    on them (to the bit its plain version) beside ``index_add_``."""
    import torch

    from pecanpy_tpu_torch.ops import apply as apply_lib

    if sorted(streams) != ["W_in", "W_out"]:
        raise AssertionError(f"streams recorded: {sorted(streams)}")
    big = apply_lib.long_segment_rows()
    table0 = ((torch.rand(NODES, DIM, device="cuda") - 0.5) / DIM).to(dtype)
    for label, (ids_s, upd_s, seed) in streams.items():
        counts = torch.unique_consecutive(ids_s, return_counts=True)[1]
        long_ = counts[counts > big]
        t_k = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, seed)
        t_p = apply_lib.apply_sorted_stream_plain(table0.clone(), ids_s, upd_s, seed)
        torch.cuda.synchronize()
        assert_bit_equal(f"kernel 2.1 on the hub path's {label} stream", t_k, t_p)
        del t_k, t_p
        table = table0.clone()
        ids_l, upd_l = ids_s.long(), upd_s.to(dtype)
        dev = {k: device_ms(fn) for k, fn in {
            "2.1": lambda: apply_lib.apply_sorted_stream(table, ids_s, upd_s, seed),
            "windowed": lambda: apply_lib.apply_sorted_stream_windowed(table, ids_s, upd_s, seed),
            "index_add_": lambda: table.index_add_(0, ids_l, upd_l, alpha=-1),
        }.items()}
        log(f"[6f streams] {label} (R={ids_s.numel()}, {counts.numel()} segments): longest "
            f"segment {int(counts.max())} rows; {long_.numel()} segments of more than "
            f"{big} rows, holding {int(long_.sum())} rows; kernel 2.1 bit-equal to plain; "
            f"device time {str(dtype).replace('torch.', '')}: 2.1 {dev['2.1']:.4f} ms, windowed {dev['windowed']:.4f} ms, "
            f"index_add_ {dev['index_add_']:.4f} ms")
        del table, ids_l, upd_l
    del table0
    torch.cuda.empty_cache()


def longest_segment(ids_s) -> int:
    """Rows of the longest run of one id in a sorted stream."""
    import torch

    return int(torch.unique_consecutive(ids_s, return_counts=True)[1].max())


def make_hot_stream(r, n, d, seed):
    """Random sorted ids with one row repeated ``HOT_ROW`` times: a segment
    that spans many windows of the windowed kernel."""
    import torch

    gen = np.random.default_rng(seed)
    ids = np.concatenate([gen.integers(0, n, r - HOT_ROW), np.full(HOT_ROW, n // 3 + 1)])
    ids_s = torch.from_numpy(np.sort(ids).astype(np.int32)).cuda()
    return ids_s, (torch.randn(r, d, device="cuda") * 1e-3).contiguous()


def make_boundary_stream(r, n, d, grid, seed):
    """Random sorted ids with a hot segment of ``BOUNDARY_ROW`` rows that
    starts in the windowed kernel's block 0 and runs across the first block
    boundary ``r // grid`` into the ranges of the next blocks."""
    import torch

    gen = np.random.default_rng(seed)
    ids = np.sort(gen.integers(0, n, r))
    a = max(r // grid - BOUNDARY_ROW // 4, 0)
    ids[a:a + BOUNDARY_ROW] = ids[a]
    ids_s = torch.from_numpy(ids.astype(np.int32)).cuda()
    return ids_s, (torch.randn(r, d, device="cuda") * 1e-3).contiguous()


def make_short_stream(r, n, d, seed):
    """``r`` random sorted ids, fewer than the windowed kernel's blocks."""
    import torch

    gen = np.random.default_rng(seed)
    ids_s = torch.from_numpy(np.sort(gen.integers(0, n, r)).astype(np.int32)).cuda()
    return ids_s, (torch.randn(r, d, device="cuda") * 1e-3).contiguous()


def phase_windowed():
    """7a: the windowed kernel against kernel 2.1 (bit for bit) and its
    plain version, on phase 3's streams, a hot-row stream, a stream whose
    hot segment crosses the kernel's first block boundary and one shorter
    than its grid; times by CUDA events and by device time."""
    import torch

    from pecanpy_tpu_torch.ops import apply as apply_lib

    n, d = NODES, DIM
    r_in = 1235 * (WALK_LENGTH + 1)
    r_out = r_in + NEG_POOL
    base = (torch.rand(n, d, device="cuda") - 0.5) / d
    streams = {"R=%d" % r: make_stream(r, n, d, seed=r) for r in (r_in, r_out)}
    streams["hot"] = make_hot_stream(r_in, n, d, seed=7)
    streams["R=%d" % SHORT_ROWS] = make_short_stream(SHORT_ROWS, n, d, seed=11)
    results, max_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        table0 = base.to(dtype)
        name = str(dtype).replace("torch.", "")
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        grid = apply_lib.windowed_grid(table0, streams["hot"][1])
        if grid <= SHORT_ROWS:
            raise AssertionError(f"grid {grid}: the short stream has more rows than blocks")
        per_dtype = dict(streams, boundary=make_boundary_stream(r_in, n, d, grid, seed=13))
        for label, (ids_s, upd_s) in per_dtype.items():
            seed = 777
            t_w = apply_lib.apply_sorted_stream_windowed(table0.clone(), ids_s, upd_s, seed)
            t_21 = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, seed)
            t_p = apply_lib.apply_sorted_stream_windowed_plain(table0.clone(), ids_s, upd_s, seed)
            t_21p = apply_lib.apply_sorted_stream_plain(table0.clone(), ids_s, upd_s, seed)
            torch.cuda.synchronize()
            assert_bit_equal(f"windowed {name} {label} against kernel 2.1", t_w, t_21)
            # kernel 2.1's long pass sums the hot and boundary segments
            assert_bit_equal(f"kernel 2.1 {name} {label} against its plain version", t_21, t_21p)
            err, check, touched = compare_with_plain(f"windowed {name} {label}", t_w, t_p,
                                                     table0, ids_s)
            max_err = max(max_err, err)
            del t_w, t_21, t_p, t_21p
            table = table0.clone()
            ids_l, upd_l = ids_s.long(), upd_s.to(dtype)
            calls = {
                "windowed": lambda: apply_lib.apply_sorted_stream_windowed(
                    table, ids_s, upd_s, seed),
                "2.1": lambda: apply_lib.apply_sorted_stream(table, ids_s, upd_s, seed),
                "index_add_": lambda: table.index_add_(0, ids_l, upd_l, alpha=-1),
            }
            ev = {k: cuda_median_ms(fn) for k, fn in calls.items()}
            dev = {k: device_ms(fn) for k, fn in calls.items()}
            plain_ms = cuda_median_ms(
                lambda: apply_lib.apply_sorted_stream_windowed_plain(table, ids_s, upd_s, seed))
            n_touched = int(touched.sum())
            nbytes = ids_s.numel() * 4 + upd_s.numel() * 4 + 2 * n_touched * d * table.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"[7a windowed] {name} {label} (R={ids_s.numel()}, grid {grid}, longest "
                f"segment {longest_segment(ids_s)}): bit-equal to kernel 2.1, and 2.1 to its "
                f"plain version; max_abs_err vs plain {err:.3e} ({check}); CUDA events: "
                f"windowed {ev['windowed']:.4f} ms, 2.1 {ev['2.1']:.4f} ms, index_add_ "
                f"{ev['index_add_']:.4f} ms, plain {plain_ms:.4f} ms; device: windowed "
                f"{dev['windowed']:.4f} ms, 2.1 {dev['2.1']:.4f} ms, index_add_ "
                f"{dev['index_add_']:.4f} ms; {n_touched} touched rows, {nbytes / 1e6:.2f} MB "
                f"moved at least: bound {bound_ms:.4f} ms")
            log(f"[7a windowed] {name} {label}: kernel 2.1 device time "
                f"{'below' if dev['2.1'] < dev['index_add_'] else 'NOT below'} index_add_'s "
                f"({dev['2.1']:.4f} against {dev['index_add_']:.4f} ms)")
            results[(name, label)] = dict(ms=ev["windowed"], device_ms=dev["windowed"],
                                          plain_ms=plain_ms, library_ms=ev["index_add_"],
                                          bound_ms=bound_ms)
            del table, ids_l, upd_l
        del table0, per_dtype
    del base, streams
    torch.cuda.empty_cache()
    return results, max_err


def phase_precomp(tmp):
    """7b, 7c: PreComp on the 1M-node bench graph with the windowed applier,
    and its second-order law on a small graph."""
    import torch

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.ops import apply as apply_lib

    raw = np.load(os.path.join(tmp, "bench_graph.csr.npz"))
    indptr, indices = raw["indptr"], raw["indices"]
    g = pecanpy.PreComp(p=0.5, q=2.0, random_state=0, device="cuda")
    g.read_npz(os.path.join(tmp, "bench_graph.csr.npz"), weighted=True, implicit_ids=True)
    t0 = time.perf_counter()
    g.preprocess_transition_probs()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    e, w = g.edge_cdf.shape
    if e != indices.size or e * w >= 2**31:
        raise AssertionError(f"edge_cdf {tuple(g.edge_cdf.shape)} for {indices.size} edges")
    dg = g.get_device_graph()
    log(f"[7b precomp] layout + edge-CDF build in {dt:.2f} s: edge_cdf [{e}, {w}] f32 "
        f"({e * w * 4 / 1e9:.2f} GB, E*w = {e * w:.3e} < 2^31); fused {tuple(dg.fused.shape)} "
        f"channels {dg.channels}")
    g.simulate_walks_device(1, 8)  # warm-up at a short length
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walks, eff = g.simulate_walks_device(1, WALK_LENGTH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    walks_np, eff_np = walks.cpu().numpy(), eff.cpu().numpy()
    steps = int((eff_np - 1).sum())
    n_checked = check_walks_follow_edges(walks_np, eff_np, indptr, indices, NODES)
    log(f"[7b precomp] walks {tuple(walks.shape)} in {dt:.3f} s: {steps / dt:.4e} effective "
        f"walk steps/s; all {n_checked} sampled steps are edges")
    del walks, eff

    v2 = apply_lib.APPLY_V2
    apply_lib.APPLY_V2 = True
    try:
        apply_lib.apply_sorted_stream.launches = 0
        apply_lib.apply_sorted_stream_windowed.launches = 0
        t0 = time.perf_counter()
        emb = g.embed(dim=DIM, num_walks=1, walk_length=WALK_LENGTH,
                      window_size=WINDOW, max_steps=MAX_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = apply_lib.apply_sorted_stream_windowed.launches
        old = apply_lib.apply_sorted_stream.launches
    finally:
        apply_lib.APPLY_V2 = v2
    log(f"[7b precomp] embed with PECANPY_TPU_APPLY_V2: windowed launches {launches}, "
        f"kernel 2.1 launches {old}, in {MAX_STEPS} chunk-steps ({dt:.2f} s incl. walks)")
    if launches != 2 * MAX_STEPS or old != 0:
        raise AssertionError(f"windowed {launches} (want {2 * MAX_STEPS}), 2.1 {old} (want 0)")
    if emb.shape != (NODES, DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    del g, dg, emb
    torch.cuda.empty_cache()

    # -- c. the second-order law: table rows and the wide-degree fallback --
    law_rng = np.random.default_rng(4)
    n = 40
    adj = (law_rng.random((n, n)) < 0.25) * law_rng.uniform(0.2, 3.0, (n, n))
    np.fill_diagonal(adj, 0.0)
    adj = np.triu(adj) + np.triu(adj, 1).T
    for i in np.nonzero(adj.sum(1) == 0)[0]:
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.5
    deg = (adj != 0).sum(1)
    # a 40-node graph has no degree above 64: a narrower table row sends
    # the nodes above it through the on-the-fly fallback
    small = pecanpy.PreComp.from_mat(adj, [str(i) for i in range(n)], p=0.5, q=2.0,
                                     random_state=1, device="cuda")
    small.PRECOMP_WIDTH = PRECOMP_LAW_WIDTH
    small.preprocess_transition_probs()
    wide = int((deg > small.edge_cdf.shape[1]).sum())
    if not 0 < wide < n:
        raise AssertionError(f"law graph: {wide} of {n} nodes above the table width")
    w_l, e_l = small.simulate_walks_device(2000, 6)
    w_l, e_l = w_l.cpu().numpy(), e_l.cpu().numpy()
    if (e_l != 7).any():
        raise AssertionError("every law-graph node has out-edges")
    checked, worst = second_order_worst(w_l, adj, 0.5, 2.0)
    if checked < 50 or worst > LAW_SIGMAS:
        raise AssertionError(f"PreComp law: {checked} pairs, worst {worst:.2f} sigma")
    log(f"[7c law] PreComp, table width {small.edge_cdf.shape[1]}, {wide} of {n} nodes "
        f"through the fallback: {checked} (prev, cur) pairs, worst frequency {worst:.2f} "
        f"binomial sigma (limit {LAW_SIGMAS})")
    return launches


def small_hub_graph(rng, n=60, cap=6):
    """An undirected float-weight graph whose nodes 0 and 1 are hubs above
    ``cap``; every node has an edge."""
    adj = (rng.random((n, n)) < 4.0 / n) * rng.uniform(0.5, 2.0, (n, n))
    for hub in (0, 1):
        nbrs = rng.choice(np.arange(2, n), 20, replace=False)
        adj[hub, nbrs] = rng.uniform(0.5, 2.0, 20)
    np.fill_diagonal(adj, 0.0)
    adj = np.maximum(adj, adj.T)
    for i in np.nonzero(adj.sum(1) == 0)[0]:
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.0
    return adj


def phase_first_order(tmp):
    """7d: FirstOrderUnweighted and PreCompFirstOrder on the power-law graph
    through the scan engine's hub-aware draws, and their laws."""
    import torch

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.ops.layout import DEFAULT_DEGREE_CAP

    path = os.path.join(tmp, "powerlaw_graph.csr.npz")
    raw = np.load(path)
    indptr, indices = raw["indptr"], raw["indices"]
    deg = np.diff(indptr)
    for cls, weighted in ((pecanpy.FirstOrderUnweighted, False),
                          (pecanpy.PreCompFirstOrder, True)):
        name = cls.__name__
        g = cls(random_state=0, walker_batch=131_072, device="cuda")
        g.read_npz(path, weighted=weighted, implicit_ids=True)
        t0 = time.perf_counter()
        g.preprocess_transition_probs()
        torch.cuda.synchronize()
        dt_layout = time.perf_counter() - t0
        dg = g.get_device_graph()
        if not dg.has_hubs or ("cdf" in dg.channels) != weighted:
            raise AssertionError(f"{name}: has_hubs {dg.has_hubs}, channels {dg.channels}")
        t0 = time.perf_counter()
        walks, eff = g.simulate_walks_device(1, WALK_LENGTH)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        walks_np, eff_np = walks.cpu().numpy(), eff.cpu().numpy()
        steps = int((eff_np - 1).sum())
        n_checked = check_walks_follow_edges(walks_np, eff_np, indptr, indices, NODES)
        hub_rows = np.nonzero(deg[walks_np[:, 0]] > DEFAULT_DEGREE_CAP)[0]
        if (walks_np[hub_rows, 1] == walks_np[hub_rows, 0]).any():
            raise AssertionError(f"{name}: a walk stayed on its hub start")
        n_hub = check_walks_follow_edges(walks_np[hub_rows], eff_np[hub_rows], indptr, indices,
                                         NODES, min(10_000, hub_rows.size))
        log(f"[7d first-order] {name}: layout {dt_layout:.2f} s, channels {dg.channels}; "
            f"walks {tuple(walks.shape)} on {g._resolved_walker_batch()} walkers per chunk in "
            f"{dt:.3f} s: {steps / dt:.4e} effective steps/s; all {n_checked} sampled steps "
            f"are edges; {hub_rows.size} walks start on hubs, all leave them ({n_hub} steps "
            "checked)")
        del g, dg, walks, eff
        torch.cuda.empty_cache()

    adj = small_hub_graph(np.random.default_rng(5))
    unweighted = (adj != 0).astype(float)
    ids = [str(i) for i in range(adj.shape[0])]
    for cls, a in ((pecanpy.FirstOrderUnweighted, unweighted), (pecanpy.PreCompFirstOrder, adj)):
        g = cls.from_mat(a, ids, degree_cap=6, random_state=2, device="cuda")
        if not g.get_device_graph().has_hubs:
            raise AssertionError("small hub graph without hubs")
        walks, eff = g.simulate_walks_device(2000, 4)
        checked, worst = first_order_worst(walks.cpu().numpy(), eff.cpu().numpy(), a,
                                           lambda cu, a=a: a[cu][a[cu] != 0] / a[cu].sum())
        if checked < 40 or worst > LAW_SIGMAS:
            raise AssertionError(f"{cls.__name__} law: {checked} nodes, worst {worst:.2f}")
        log(f"[7d law] {cls.__name__} (degree_cap 6, 2 hubs): {checked} nodes, worst "
            f"frequency {worst:.2f} binomial sigma (limit {LAW_SIGMAS})")


def run_cli(*args, env=None):
    subprocess.run([sys.executable, "-m", "pecanpy_tpu_torch.cli", *args],
                   cwd=REPO, check=True, timeout=600, env=env)


def phase_n2vpp_and_cli(tmp):
    """7e: Node2vecPlusPlus on a dense graph; the CLI's conversion and walk
    tasks, and PreComp with the windowed applier through the CLI."""
    from pecanpy_tpu_torch.experimental import Node2vecPlusPlus

    n = 2000
    indptr, indices, data = build_bench_graph(n, MEAN_DEGREE, seed=1)
    adj = np.zeros((n, n))
    adj[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    g = Node2vecPlusPlus.from_mat(adj, [str(i) for i in range(n)], p=0.5, q=2.0,
                                  random_state=0, device="cuda")
    walks, eff = g.simulate_walks_device(2, WALK_LENGTH)
    n_checked = check_walks_follow_edges(walks.cpu().numpy(), eff.cpu().numpy(), indptr,
                                         indices, n, 2000)
    log(f"[7e n2v++] dense {n}-node graph, walks {tuple(walks.shape)}: all {n_checked} "
        "sampled steps are edges")

    karate = os.path.join(REPO, "demo", "karate.edg")
    csr = os.path.join(tmp, "karate.csr.npz")
    run_cli("--task", "tocsr", "--input", karate, "--output", csr)
    env = dict(os.environ, PECANPY_TPU_APPLY_V2="1")
    outs = []
    for i in range(2):
        out = os.path.join(tmp, f"kp{i}.emb")
        run_cli("--input", csr, "--output", out, "--mode", "PreComp", "--dimensions", "16",
                "--walk-length", "10", "--num-walks", "3", "--window-size", "4", "--p", "0.5",
                "--q", "2", "--random_state", "0", env=env)
        with open(out, "rb") as f:
            outs.append(f.read())
    if outs[0].split(b"\n", 1)[0] != b"34 16" or outs[0] != outs[1]:
        raise AssertionError("CLI PreComp from the .csr.npz: header or reproducibility")
    walks_out = os.path.join(tmp, "k.walks")
    run_cli("--task", "walks", "--input", karate, "--output", walks_out, "--mode", "PreComp",
            "--walk-length", "10", "--num-walks", "2", "--p", "0.5", "--q", "2",
            "--random_state", "0")
    edges = set()
    with open(karate) as f:
        for line in f:
            a, b = line.split()[:2]
            edges |= {(a, b), (b, a)}
    with open(walks_out) as f:
        lines = [line.split() for line in f]
    bad = sum((a, b) not in edges for w in lines for a, b in zip(w, w[1:]))
    if len(lines) != 68 or bad:
        raise AssertionError(f"CLI walks: {len(lines)} lines, {bad} non-edge steps")
    log("[7e cli] karate: tocsr -> .csr.npz -> PreComp with PECANPY_TPU_APPLY_V2=1, two "
        f"runs byte-identical; --task walks: {len(lines)} walks, every step an edge")


def phase_precomp_quality():
    """7f: the block-model gate through PreComp with the windowed applier."""
    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.ops import apply as apply_lib

    rng = np.random.default_rng(0)
    adj, labels = sbm_graph(rng)
    v2 = apply_lib.APPLY_V2
    apply_lib.APPLY_V2 = True
    try:
        before = apply_lib.apply_sorted_stream_windowed.launches
        g = pecanpy.PreComp.from_mat(adj, [str(i) for i in range(adj.shape[0])],
                                     random_state=0, device="cuda")
        emb = g.embed(dim=32, num_walks=8, walk_length=30, window_size=5, epochs=3)
        launches = apply_lib.apply_sorted_stream_windowed.launches - before
    finally:
        apply_lib.APPLY_V2 = v2
    f1 = micro_f1_nearest_centroid(emb, labels, rng)
    log(f"[7f quality] block-model graph through PreComp, windowed applier ({launches} "
        f"launches): micro-F1 {f1:.4f} (gate 0.9)")
    if f1 < 0.9 or launches == 0:
        raise AssertionError(f"micro-F1 {f1:.4f}, {launches} windowed launches")


def run_captured(fn, *args, **kwargs):
    """Call ``fn``; returns (its result, what it printed). The printout is
    logged as well."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kwargs)
    for line in buf.getvalue().splitlines():
        log(f"    | {line}")
    return result, buf.getvalue()


def timer_seconds(text, name):
    """The seconds of a ``wrappers.Timer`` line ``Took HH:MM:SS.ss to name``."""
    m = re.search(r"Took (\d+):(\d+):([\d.]+) to " + re.escape(name) + "$", text, re.M)
    if m is None:
        raise AssertionError(f"no Timer line for {name!r} in the printout")
    return int(m[1]) * 3600 + int(m[2]) * 60 + float(m[3])


def sequential_pairs(text):
    """(pairs, threads) from the sequential trainer's verbose line."""
    m = re.search(r"sequential SGNS: (\d+) pairs on (\d+) thread\(s\)", text)
    if m is None:
        raise AssertionError("the sequential trainer printed no pair count")
    return int(m[1]), int(m[2])


def write_edg(path, indptr, indices):
    """An undirected unit-weight CSR as a 3-column edgelist, each edge once."""
    u = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    keep = u < indices
    with open(path, "w") as f:
        f.write("".join(f"{a}\t{b}\t1\n" for a, b in zip(u[keep], indices[keep])))


def alias_law_error(edge_pack, hub_base, indptr, indices, data, hub_ids):
    """Worst gap between the neighbour law that each hub's alias rows imply
    (slot s gives its own neighbour acceptance q_s / k and its alias the
    rest, (1 - q_s) / k) and the exact law w / sum(w)."""
    counts = (indptr[hub_ids + 1] - indptr[hub_ids]).astype(np.int64)
    hub_of = np.repeat(np.arange(hub_ids.size), counts)
    edge = np.concatenate([np.arange(indptr[h], indptr[h + 1]) for h in hub_ids])
    rows = edge_pack[np.concatenate([np.arange(b, b + k) for b, k in zip(hub_base, counts)])]
    acc = rows[:, 0].astype(np.float64)
    alias_nbr = rows.view(np.int32)[:, 3].astype(np.int64)
    n = int(indptr.size)
    keys = hub_of * n + indices[edge].astype(np.int64)  # ascending: sorted rows
    alias_pos = np.searchsorted(keys, hub_of * n + alias_nbr)
    if not np.array_equal(keys[alias_pos], hub_of * n + alias_nbr):
        raise AssertionError("an alias slot names a node outside its hub's row")
    k = counts[hub_of].astype(np.float64)
    law = acc / k + np.bincount(alias_pos, (1.0 - acc) / k, minlength=keys.size)
    w = data[edge].astype(np.float64)
    wsum = np.bincount(hub_of, w)[hub_of]
    return float(np.abs(law - w / wsum).max())


def sparse_first_order_worst(walks, eff, indptr, indices, min_count=400):
    """Empirical cur -> next frequencies of unit-weight walks against the
    uniform law over cur's neighbours, from the CSR (no dense matrix):
    (nodes checked, worst deviation in binomial sigma)."""
    n = indptr.size - 1
    valid = np.arange(walks.shape[1] - 1)[None, :] < (eff[:, None] - 1)
    cur = walks[:, :-1][valid].astype(np.int64)
    keys = cur * n + walks[:, 1:][valid]
    row_of_edge = np.repeat(np.arange(n), np.diff(indptr))
    edge_keys = row_of_edge * n + indices.astype(np.int64)  # sorted (CSR)
    pos = np.searchsorted(edge_keys, keys)
    if not np.array_equal(edge_keys[np.minimum(pos, edge_keys.size - 1)], keys):
        raise AssertionError("a walk step is not an edge")
    per_edge = np.bincount(pos, minlength=edge_keys.size)
    tot = np.bincount(cur, minlength=n)[row_of_edge]
    deg = np.diff(indptr)[row_of_edge]
    ok = tot >= min_count
    dev = np.abs(per_edge[ok] / tot[ok] - 1.0 / deg[ok]) / np.sqrt(0.25 / tot[ok])
    return int(np.unique(row_of_edge[ok]).size), float(dev.max())


def phase_quality(tmp):
    """8: the quality protocol of ``benchmarks/bench_quality.py`` through
    the port's entry points; returns the ``quality`` record."""
    import torch

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.graph import SparseGraph
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.native import loader
    from pecanpy_tpu_torch.ops import apply as apply_lib
    from pecanpy_tpu_torch.ops import hubs, trialkernel
    from pecanpy_tpu_torch.ops.layout import DEFAULT_DEGREE_CAP
    from pecanpy_tpu_torch.utils import evaluate

    record = {}
    # -- a. the graph, through the native and the Python parser ----------
    t0 = time.perf_counter()
    indptr, indices, _, labels = evaluate.overlapping_sbm(
        n=QUALITY_NODES, n_communities=QUALITY_COMMUNITIES,
        mean_degree=QUALITY_MEAN_DEGREE, seed=1)
    path = os.path.join(tmp, "quality_sbm.edg")
    write_edg(path, indptr, indices)
    log(f"[8a quality] overlapping SBM: {QUALITY_NODES} nodes, {indices.size} directed "
        f"edges, max degree {int(np.diff(indptr).max())}, {QUALITY_COMMUNITIES} labels, "
        f"{labels.sum(1).mean():.2f} a node; built + written in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    if not loader.native_available():
        raise AssertionError("the native library did not build")
    build_s = time.perf_counter() - t0
    g = pecanpy.SparseOTF(random_state=0, workers=0, device="cuda")
    t0 = time.perf_counter()
    g.read_edg(path, weighted=True, directed=False, engine="native")
    native_s = time.perf_counter() - t0
    py = SparseGraph()
    t0 = time.perf_counter()
    py.read_edg(path, weighted=True, directed=False, engine="python")
    python_s = time.perf_counter() - t0
    for name in ("indptr", "indices", "data"):
        a, b = getattr(g, name), getattr(py, name)
        if a.dtype != b.dtype or not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"native and Python parsers differ in {name}")
    if g.nodes != py.nodes or g.num_edges != indices.size:
        raise AssertionError(f"IDs differ or {g.num_edges} edges (want {indices.size})")
    labels = labels[np.array([int(x) for x in g.nodes])]  # rows follow g.nodes
    record["parse_s"] = {"native": native_s, "python": python_s, "native_build": build_s}
    log(f"[8a quality] native library built and loaded in {build_s:.2f} s from "
        f"{os.path.relpath(loader.NATIVE_DIR, REPO)} into "
        f"{os.path.relpath(loader.BUILD_DIR, REPO)}; read_edg: native {native_s:.4f} s, "
        f"python {python_s:.4f} s; CSR and IDs bit-equal")

    # -- b. the batched trainer, every update through kernel 2.1 ---------
    walk_cols = WALK_LENGTH + 1
    config = sgns.SGNSConfig(dim=DIM, window=WINDOW, seed=0)
    dtype = sgns.resolve_table_dtype(config, g.num_nodes, "cuda")
    if dtype != torch.float32:
        raise AssertionError(f"tables resolved to {dtype}, expected float32")
    chunk = sgns.resolve_batch_walks(config, g.num_nodes, walk_cols)
    chunk_steps = -(-10 * g.num_nodes // chunk)
    apply_lib.apply_sorted_stream.launches = 0
    apply_lib.apply_sorted_stream_windowed.launches = 0
    trialkernel.trial_propose.launches = trialkernel.trial_accept.launches = 0
    t0 = time.perf_counter()
    emb, text = run_captured(
        g.embed, dim=DIM, num_walks=10, walk_length=WALK_LENGTH, window_size=WINDOW,
        epochs=1, table_dtype="auto", verbose=True)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    launches = {
        "apply_sorted_stream": apply_lib.apply_sorted_stream.launches,
        "apply_sorted_stream_windowed": apply_lib.apply_sorted_stream_windowed.launches,
        "trial_propose": trialkernel.trial_propose.launches,
        "trial_accept": trialkernel.trial_accept.launches,
    }
    if launches != {"apply_sorted_stream": 2 * chunk_steps, "apply_sorted_stream_windowed": 0,
                    "trial_propose": 0, "trial_accept": 0}:
        raise AssertionError(f"launches {launches}, want 2 x {chunk_steps} of kernel 2.1 only")
    if emb.shape != (g.num_nodes, DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    walk_s = timer_seconds(text, "generate walks")
    train_s = timer_seconds(text, "train embeddings")
    walks, eff = g.simulate_walks_device(10, WALK_LENGTH)  # the walks embed trained on
    checked, worst = sparse_first_order_worst(walks.cpu().numpy(), eff.cpu().numpy(),
                                              g.indptr, g.indices)
    log(f"[8b quality] walks (p = q = 1): {checked} nodes, worst cur -> next frequency "
        f"{worst:.2f} binomial sigma from the uniform law (limit {LAW_SIGMAS})")
    if checked < QUALITY_NODES // 2 or worst > LAW_SIGMAS:
        raise AssertionError(f"quality walks' law: {checked} nodes, worst {worst:.2f} sigma")
    del walks, eff
    t0 = time.perf_counter()
    f1 = evaluate.multilabel_node_classification(emb, labels, train_fraction=0.5, seed=0,
                                                 device="cuda")
    eval_s = time.perf_counter() - t0
    record["batched"] = {
        "micro_f1": f1, "gate": QUALITY_GATE_BATCHED, "epochs": 1, "table_dtype": "float32",
        "embed_s": embed_s, "walk_s": walk_s, "train_s": train_s, "eval_s": eval_s,
        "walks_per_chunk_step": chunk, "chunk_steps": chunk_steps,
        "chunk_step_ms": 1e3 * train_s / chunk_steps, "launches": launches}
    log(f"[8b quality] batched f32: micro-F1 {f1:.4f} (gate {QUALITY_GATE_BATCHED}); embed "
        f"{embed_s:.2f} s (walks {walk_s:.2f} s, training {train_s:.2f} s: {chunk_steps} "
        f"chunk-steps of {chunk} walks, {1e3 * train_s / chunk_steps:.3f} ms each); kernel "
        f"2.1 launches {launches['apply_sorted_stream']}, no other kernel; eval {eval_s:.2f} s")
    if f1 < QUALITY_GATE_BATCHED:
        raise AssertionError(f"batched micro-F1 {f1:.4f} below {QUALITY_GATE_BATCHED}")

    # -- c. the random-embedding floor ------------------------------------
    rand = np.random.default_rng(9).standard_normal(emb.shape).astype(np.float32)
    floor = evaluate.multilabel_node_classification(rand, labels, train_fraction=0.5, seed=0,
                                                    device="cuda")
    record["floor"] = {"micro_f1": floor, "limit": QUALITY_FLOOR_LIMIT}
    log(f"[8c quality] random-embedding floor: micro-F1 {floor:.4f} (limit "
        f"{QUALITY_FLOOR_LIMIT})")
    if floor >= QUALITY_FLOOR_LIMIT:
        raise AssertionError(f"random-embedding floor {floor:.4f} not below {QUALITY_FLOOR_LIMIT}")
    del emb

    # -- d. the sequential trainer, hogwild over every host thread --------
    t0 = time.perf_counter()
    emb_s, text = run_captured(
        g.embed, dim=DIM, num_walks=10, walk_length=WALK_LENGTH, window_size=WINDOW,
        epochs=1, trainer="sequential", verbose=True)
    seq_s = time.perf_counter() - t0
    pairs, threads = sequential_pairs(text)
    train_s = timer_seconds(text, "train embeddings (sequential)")
    if emb_s.shape != (g.num_nodes, DIM) or not np.isfinite(emb_s).all():
        raise AssertionError(f"sequential embeddings {emb_s.shape}")
    f1_s = evaluate.multilabel_node_classification(emb_s, labels, train_fraction=0.5, seed=0,
                                                   device="cuda")
    record["sequential"] = {
        "micro_f1": f1_s, "gate": QUALITY_GATE_SEQUENTIAL, "threads": threads,
        "embed_s": seq_s, "train_s": train_s, "pairs": pairs, "pairs_per_s": pairs / train_s}
    log(f"[8d quality] sequential, {threads} hogwild threads: micro-F1 {f1_s:.4f} (gate "
        f"{QUALITY_GATE_SEQUENTIAL}); {pairs} pairs in {train_s:.2f} s of training "
        f"({pairs / train_s:.4e} pairs/s), embed {seq_s:.2f} s")
    if f1_s < QUALITY_GATE_SEQUENTIAL:
        raise AssertionError(f"sequential micro-F1 {f1_s:.4f} below {QUALITY_GATE_SEQUENTIAL}")
    del g, emb_s

    # -- e. the hub builders on phase 6's graph ---------------------------
    raw = np.load(os.path.join(tmp, "powerlaw_graph.csr.npz"))
    p_indptr, p_indices, p_data = raw["indptr"], raw["indices"], raw["data"]
    hub_ids = np.nonzero(np.diff(p_indptr) > DEFAULT_DEGREE_CAP)[0].astype(np.int32)
    t0 = time.perf_counter()
    nat = loader.build_hub_tables_native(p_indptr, p_indices, p_data, hub_ids)
    hub_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pyt = hubs.build_python(p_indptr, p_indices, p_data, hub_ids)
    hub_python_s = time.perf_counter() - t0
    for i, name in ((1, "hub_base"), (2, "hkey8"), (3, "hval8"), (4, "bucket_base"),
                    (5, "bucket_log")):
        if nat[i].dtype != pyt[i].dtype or nat[i].tobytes() != pyt[i].tobytes():
            raise AssertionError(f"native and Python hub builders differ in {name}")
    law_err = max(alias_law_error(t[0], t[1], p_indptr, p_indices, p_data, hub_ids)
                  for t in (nat, pyt))
    record["hub_build_s"] = {"native": hub_native_s, "python": hub_python_s,
                             "hubs": int(hub_ids.size), "hub_edges": int(nat[0].shape[0]),
                             "alias_law_max_err": law_err}
    log(f"[8e hubs] {hub_ids.size} hubs, {nat[0].shape[0]} hub edges: native builder "
        f"{hub_native_s:.3f} s, Python {hub_python_s:.3f} s ({hub_python_s / hub_native_s:.1f}x); "
        f"hash tables byte-equal, alias laws within {law_err:.2e} of the exact law "
        f"(limit {ALIAS_LAW_TOL:g})")
    if law_err > ALIAS_LAW_TOL:
        raise AssertionError(f"alias law error {law_err:.2e} above {ALIAS_LAW_TOL}")
    return record


def main():
    import torch

    sys.path.insert(0, REPO)
    import pecanpy_tpu_torch

    if os.path.dirname(os.path.abspath(pecanpy_tpu_torch.__file__)) != os.path.join(
        REPO, "pecanpy_tpu_torch"
    ):
        raise RuntimeError("pecanpy_tpu_torch must come from this checkout")
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    results, max_err = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(tmp)
        phase_cli(tmp)
        hub_results, hub_launches = phase_hub_path(tmp)
        t7 = time.perf_counter()
        win_results, win_err = phase_windowed()
        win_launches = phase_precomp(tmp)
        phase_first_order(tmp)
        phase_n2vpp_and_cli(tmp)
        phase_precomp_quality()
        log(f"[7] phase 7 took {time.perf_counter() - t7:.1f} s")
        t8 = time.perf_counter()
        quality = phase_quality(tmp)
        quality["phase_s"] = time.perf_counter() - t8
        log(f"[8] phase 8 took {quality['phase_s']:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    r_out = 1235 * (WALK_LENGTH + 1) + NEG_POOL
    rows = [
        ("apply_sorted_stream", "apply.cu", "apply.py:169", launches,
         dict(results[("bfloat16", r_out)], max_abs_err=max_err)),
        ("trial_propose", "trial.cu", "trialkernel.py:84",
         hub_launches["trial_propose"], dict(hub_results["trial_propose"], library_ms=None)),
        ("trial_accept", "trial.cu", "trialkernel.py:166",
         hub_launches["trial_accept"], dict(hub_results["trial_accept"], library_ms=None)),
        ("apply_sorted_stream_windowed", "apply_v2.cu", "apply.py:296", win_launches,
         dict(win_results[("bfloat16", f"R={r_out}")], max_abs_err=win_err)),
    ]
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"pecanpy_tpu_torch/csrc/{src}",
        "replaces": f"pecanpy_tpu/ops/{tpu}",
        "launches": n,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": "bytes",
        "library_ms": r["library_ms"],
    } for name, src, tpu, n, r in rows]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"quality": quality}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
