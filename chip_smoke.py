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
   stream sizes, f32 and bf16, with both times (CUDA events, median of 20);
4. main path at full width: the 1M-node, mean-degree-16 weighted graph of
   ``bench.py``, read from a ``.csr.npz``, walked (p=0.5, q=2), then
   ``embed(dim=128, num_walks=1, walk_length=80, max_steps=50)`` with
   bf16 tables; the applier's launch count must rise by 2 per step;
   SGNS on a small block-model graph must recover its communities;
5. entry point: the CLI on ``demo/karate.edg`` twice, byte-identical;
6. prints the kernels JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""
import json
import os
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


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps between two bf16 tensors
    (sign-magnitude bit patterns mapped onto one ordered integer line)."""
    import torch

    def ordered(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


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
            touched = torch.zeros(n, dtype=torch.bool, device="cuda")
            touched[ids_s.long()] = True
            if not torch.equal(t_k[~touched], table0[~touched]):
                raise AssertionError(f"{dtype} R={r}: untouched rows changed")
            err = float((t_k.float() - t_p.float()).abs().max())
            if dtype == torch.float32:
                torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
                check = "allclose rtol=1e-5 atol=1e-6"
            else:
                # kernel and plain share the rounding bits: they may differ
                # only where the two f32 sums straddle a rounding boundary
                ulps = bf16_ulps(t_k[touched], t_p[touched])
                n_diff, max_ulps = int((ulps > 0).sum()), int(ulps.max())
                if max_ulps > 1 or n_diff > BF16_MISMATCH_SHARE * ulps.numel():
                    raise AssertionError(
                        f"bf16 R={r}: {n_diff} of {ulps.numel()} touched elements "
                        f"differ from plain, up to {max_ulps} ulps (allowed: "
                        f"{BF16_MISMATCH_SHARE:g} of them, 1 ulp)")
                check = (f"{n_diff} of {ulps.numel()} touched elements differ, "
                         f"max {max_ulps} bf16 ulp")
            if not bool(torch.ne(t_k[touched], table0[touched]).any()):
                raise AssertionError(f"{dtype} R={r}: no touched row moved")
            table = table0.clone()
            ms = cuda_median_ms(
                lambda: apply_lib.apply_sorted_stream(table, ids_s, upd_s, seed))
            plain_ms = cuda_median_ms(
                lambda: apply_lib.apply_sorted_stream_plain(table, ids_s, upd_s, seed))
            name = str(dtype).replace("torch.", "")
            log(f"[3 kernel] {name} R={r}: max_abs_err {err:.3e} ({check}), "
                f"untouched rows bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            results[(name, r)] = (ms, plain_ms, err)
            max_err = max(max_err, err)
            del t_k, t_p, table
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


def main():
    import torch

    sys.path.insert(0, REPO)
    import pecanpy_tpu_torch

    if os.path.dirname(os.path.abspath(pecanpy_tpu_torch.__file__)) != os.path.join(
        REPO, "pecanpy_tpu_torch"
    ):
        raise RuntimeError("pecanpy_tpu_torch must come from this checkout")
    name, smi = phase_device()
    phase_build()
    results, max_err = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(tmp)
        phase_cli(tmp)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ms, plain_ms, _ = results[("bfloat16", 1235 * (WALK_LENGTH + 1) + NEG_POOL)]
    kernels = {"kernels": [{
        "name": "apply_sorted_stream",
        "route": "cuda",
        "source": "pecanpy_tpu_torch/csrc/apply.cu",
        "replaces": "pecanpy_tpu/ops/apply.py:169",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
