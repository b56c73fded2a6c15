"""The sparse-row update applier of the PyTorch port (``ops/apply.py``).

On the CPU the public entry points take the scatter path, the one the
JAX package takes without Pallas, and they are held against it and a
numpy loop (rtol=2e-5, atol=1e-6: f32 sums in another order). The
stream prep + ``apply_sorted_stream`` route, which a CUDA table takes,
runs here through the kernel's plain version and must equal the scatter
path at the same tolerance. The windowed applier's plain version (the
port of the Pallas ``_applier_kernel_v2``) is held against that kernel
run through the Pallas interpreter (same tolerance), its window plan
against the JAX driver's formula (exactly), and ``apply_sorted_stream_plain``
(bit for bit). The CUDA kernels themselves are tested on the card
(``tests/test_torch_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecanpy_tpu.ops import apply as japply
from pecanpy_tpu_torch.ops import apply as apply_lib
from pecanpy_tpu_torch.ops.apply import apply_mean_updates, apply_mean_updates_two
from test_torch_kernels import _scan_scales

T = torch.from_numpy


def reference(table, ids, upd, cnt, lr, cap):
    sums = np.zeros_like(table)
    cnts = np.zeros(table.shape[0])
    for i, u, c in zip(ids, upd, cnt):
        sums[i] += u
        cnts[i] += c
    scale = np.minimum(cnts, cap) / np.maximum(cnts, 1e-9)
    return table - lr * sums * scale[:, None]


def _stream(rng, n, d, r):
    return (
        rng.integers(0, n, r).astype(np.int32),
        rng.normal(size=(r, d)).astype(np.float32),
        rng.integers(0, 3, r).astype(np.float32),
    )


@pytest.mark.parametrize("cap", [1.0, 4.0])
def test_matches_reference(rng, cap):
    n, d, r = 50, 16, 200
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids, upd, cnt = _stream(rng, n, d, r)
    got = apply_mean_updates(T(table.copy()), T(ids), T(upd), T(cnt), 0.05, cap=cap)
    expected = reference(table, ids, upd, cnt, 0.05, cap)
    np.testing.assert_allclose(got.numpy(), expected, rtol=2e-5, atol=1e-6)
    jax_out = japply.apply_mean_updates(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd),
        jnp.asarray(cnt), jnp.float32(0.05), cap=cap,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=2e-5, atol=1e-6)


def test_two_streams_equal_sequential(rng):
    """Merged two-stream application == the streams one by one."""
    n, d = 40, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids_a, upd_a, cnt_a = _stream(rng, n, d, 90)
    ids_b, upd_b, cnt_b = _stream(rng, n, d, 30)
    got = apply_mean_updates_two(
        T(table.copy()), T(ids_a), T(upd_a), T(cnt_a), T(ids_b), T(upd_b),
        T(cnt_b), 0.05, cap_a=4.0, cap_b=1.0,
    )
    step1 = apply_mean_updates(T(table.copy()), T(ids_a), T(upd_a), T(cnt_a), 0.05, cap=4.0)
    expected = apply_mean_updates(step1, T(ids_b), T(upd_b), T(cnt_b), 0.05, cap=1.0)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=2e-5, atol=1e-6)
    jax_out = japply.apply_mean_updates_two(
        jnp.asarray(table), jnp.asarray(ids_a), jnp.asarray(upd_a),
        jnp.asarray(cnt_a), jnp.asarray(ids_b), jnp.asarray(upd_b),
        jnp.asarray(cnt_b), jnp.float32(0.05), cap_a=4.0, cap_b=1.0,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=2e-5, atol=1e-6)


def test_untouched_rows_unchanged(rng):
    n, d = 32, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = torch.tensor([3, 3, 7], dtype=torch.int32)
    upd = T(rng.normal(size=(3, d)).astype(np.float32))
    got = apply_mean_updates(T(table.copy()), ids, upd, torch.ones(3), 0.1).numpy()
    mask = np.ones(n, bool)
    mask[[3, 7]] = False
    np.testing.assert_array_equal(got[mask], table[mask])
    assert not np.allclose(got[3], table[3])


def test_zero_count_padding_is_noop(rng):
    n, d = 16, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = torch.tensor([5, 9], dtype=torch.int32)
    got = apply_mean_updates(T(table.copy()), ids, torch.zeros(2, d), torch.zeros(2), 0.1)
    np.testing.assert_array_equal(got.numpy(), table)


def test_sorted_stream_route_equals_scatter(rng):
    """Prep (sort, group scales) + the applier's plain version == the
    scatter path, for one stream and for two merged streams."""
    n, d = 64, 12
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids_a, upd_a, cnt_a = _stream(rng, n, d, 300)
    ids_b, upd_b, cnt_b = _stream(rng, n, d, 120)
    ids_s, upd_s = apply_lib.sorted_stream_one(T(ids_a), T(upd_a), T(cnt_a), 0.05, 4.0)
    assert ids_s.dtype == torch.int32 and bool((ids_s[1:] >= ids_s[:-1]).all())
    got = apply_lib.apply_sorted_stream(T(table.copy()), ids_s, upd_s)
    want = apply_mean_updates(T(table.copy()), T(ids_a), T(upd_a), T(cnt_a), 0.05, cap=4.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-6)

    ids_s, upd_s = apply_lib.sorted_stream_two(
        T(ids_a), T(upd_a), T(cnt_a), T(ids_b), T(upd_b), T(cnt_b), 0.05, 4.0, 1.0
    )
    got = apply_lib.apply_sorted_stream(T(table.copy()), ids_s, upd_s)
    want = apply_mean_updates_two(
        T(table.copy()), T(ids_a), T(upd_a), T(cnt_a), T(ids_b), T(upd_b),
        T(cnt_b), 0.05, cap_a=4.0, cap_b=1.0,
    )
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-6)


def test_sorted_scales_equal_jax(rng):
    """Group scales over a sorted stream: bitwise equal to the JAX scans
    (integer counts make every prefix sum exact)."""
    keys = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
    cnt = rng.integers(0, 6, 500).astype(np.float32)
    cap = np.where(keys % 3 == 0, 4.0, 2.0).astype(np.float32)
    want = japply._sorted_scales(jnp.asarray(keys), jnp.asarray(cnt), jnp.float32(0.025), jnp.asarray(cap))
    got = apply_lib._sorted_scales(T(keys), T(cnt), 0.025, T(cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", [4.0, 20.0, 0.1, 7.3])
def test_sorted_scales_float_cap_equals_tensor_cap(rng, cap):
    """A float cap (a kernel argument) scales bit for bit as the same cap
    uploaded as a float32 tensor."""
    keys = np.sort(rng.integers(0, 60, 800)).astype(np.int32)
    cnt = rng.integers(0, 31, 800).astype(np.float32)
    got = apply_lib._sorted_scales(T(keys), T(cnt), 0.025, cap)
    want = apply_lib._sorted_scales(T(keys), T(cnt), 0.025, torch.tensor(cap))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _scales_case(rng, case):
    """(keys_s, cnt_s, cap) of one named stream shape."""
    if case == "single":
        keys, cnt = np.array([7], np.int32), np.array([3.0], np.float32)
    elif case == "one_group":
        keys = np.full(900, 42, np.int32)
        cnt = rng.integers(0, 21, 900).astype(np.float32)
    elif case == "all_distinct":
        keys = np.sort(rng.choice(10_000, 700, replace=False)).astype(np.int32)
        cnt = rng.integers(0, 21, 700).astype(np.float32)
    elif case == "zero_counts":
        keys = np.sort(rng.integers(0, 30, 600)).astype(np.int32)
        cnt = np.zeros(600, np.float32)
    elif case == "int32_float_cap":
        keys = np.sort(rng.integers(0, 300, 3000)).astype(np.int32)
        cnt = rng.integers(0, 21, 3000).astype(np.float32)
        return T(keys), T(cnt), 4.0
    else:  # int64 composite keys id * 2 + stream, a cap per entry
        ids = rng.integers(0, 200, 2500).astype(np.int64)
        keys = np.sort(ids * 2 + rng.integers(0, 2, 2500))
        cnt = rng.integers(0, 21, 2500).astype(np.float32)
        return T(keys), T(cnt), T(np.where(keys & 1, 1.0, 4.0).astype(np.float32))
    return T(keys), T(cnt), 4.0


@pytest.mark.parametrize("case", [
    "single", "one_group", "all_distinct", "zero_counts", "int32_float_cap",
    "int64_tensor_cap",
])
def test_sorted_scales_equal_scans(rng, case):
    """Group scales found by searching the sorted keys equal the masked
    scans' to the bit, on every stream shape the prep meets."""
    keys, cnt, cap = _scales_case(rng, case)
    got = apply_lib._sorted_scales(keys, cnt, 0.025, cap)
    want = _scan_scales(keys, cnt, 0.025, cap)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _fmix32_py(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_sr_bits_match_integer_hash():
    """The tensor hash equals the kernel's hash in Python integers."""
    seed, rows, cols = 987654321, [0, 1, 5, 999_999, 2**31 - 1], [0, 3, 127]
    got = apply_lib.sr_bits(seed, torch.tensor(rows)[:, None], torch.tensor(cols)[None, :])
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            want = _fmix32_py(_fmix32_py(_fmix32_py(seed) ^ r) ^ c)
            assert int(got[i, j]) == want


def test_bf16_stochastic_rounding_unbiased():
    """Many updates far below one bf16 ulp: the mean of the rounded rows
    lands within 3 sigma of the f32 result (round-to-nearest would drop
    every one of them)."""
    n, d, delta = 4096, 64, 1e-4
    table = torch.ones((n, d), dtype=torch.bfloat16)
    ids = torch.arange(n, dtype=torch.int32)
    upd = torch.full((n, d), delta)
    out = apply_lib.apply_sorted_stream(table, ids, upd, seed=7).to(torch.float64)
    h = 2.0**-8  # bf16 spacing just below 1.0
    p = delta / h
    sigma = h * np.sqrt(p * (1 - p) / (n * d))
    assert abs(float(out.mean()) - (1.0 - delta)) <= 3 * sigma
    assert set(np.unique(out.numpy())) <= {1.0, 1.0 - h}


def test_bf16_representable_values_stay_exact(rng):
    vals = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)).to(torch.bfloat16)
    ids = torch.arange(0, 64, 2, dtype=torch.int32)
    zero = apply_lib.apply_sorted_stream(vals.clone(), ids, torch.zeros(32, 16), seed=3)
    assert torch.equal(zero.view(torch.int16), vals.view(torch.int16))
    # an update that lands exactly on a bf16 value rounds to it exactly
    target = (vals[ids.long()].float() * 0.5).to(torch.bfloat16)
    upd = vals[ids.long()].float() - target.float()
    out = apply_lib.apply_sorted_stream(vals.clone(), ids, upd, seed=3)
    assert torch.equal(out[ids.long()].view(torch.int16), target.view(torch.int16))
    odd = torch.arange(1, 64, 2)
    assert torch.equal(out[odd].view(torch.int16), vals[odd].view(torch.int16))


def test_cpu_wrapper_never_launches(rng):
    before = apply_lib.apply_sorted_stream.launches
    table = torch.zeros((8, 4))
    apply_lib.apply_sorted_stream(table, torch.tensor([1, 1, 5], dtype=torch.int32), torch.ones(3, 4))
    assert apply_lib.apply_sorted_stream.launches == before
    np.testing.assert_array_equal(table[1].numpy(), [-2.0] * 4)


# -- the windowed applier (the port of _applier_kernel_v2) --------------------


def _windowed_stream(rng, tile, k, d):
    """Tile 0 random, tile 1 untouched, tile 2 a hot row of 700 entries
    (past one window of either plan) plus random rows; R not a multiple
    of the window."""
    r = 4 * k + 37
    ids = np.concatenate([
        rng.integers(0, tile, r - 785),
        np.full(700, 2 * tile + 5),
        rng.integers(2 * tile, 3 * tile, 85),
    ]).astype(np.int32)
    return ids, rng.normal(size=(r, d)).astype(np.float32), rng.integers(0, 3, r).astype(np.float32)


@pytest.mark.parametrize("streams", ["one", "two"])
def test_windowed_plain_equals_jax_v2_interpret(streams, rng, monkeypatch):
    """The windowed plain version, on the port's plan and on the JAX
    package's (2048-row tiles, 512-row windows), equals the JAX v2 applier
    run through the Pallas interpreter (rtol=2e-5, atol=1e-6: the one-hot
    matmul adds in another order); the untouched tile stays bit-equal."""
    monkeypatch.setattr(japply, "APPLY_V2", True)
    monkeypatch.setattr(japply, "DOT_BF16", False)  # f32-exact compare
    tile, k, d = japply.TILE, japply.K_WINDOW, 24
    n = 3 * tile
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids_a, upd_a, cnt_a = _windowed_stream(rng, tile, k, d)
    j = jnp.asarray
    if streams == "one":
        want = japply._pallas_apply_one(
            j(table), j(ids_a), j(upd_a), j(cnt_a), jnp.float32(0.05), 4.0,
            jnp.int32(3), interpret=True)
        ids_s, upd_s = apply_lib.sorted_stream_one(T(ids_a), T(upd_a), T(cnt_a), 0.05, 4.0)
    else:
        ids_b, upd_b, cnt_b = _stream(rng, n, d, k + 11)
        want = japply._pallas_apply_two(
            j(table), j(ids_a), j(upd_a), j(cnt_a), j(ids_b), j(upd_b), j(cnt_b),
            jnp.float32(0.05), 4.0, 1.0, jnp.int32(0), interpret=True)
        ids_s, upd_s = apply_lib.sorted_stream_two(
            T(ids_a), T(upd_a), T(cnt_a), T(ids_b), T(upd_b), T(cnt_b), 0.05, 4.0, 1.0)
    want = np.asarray(want)
    for plan in ({}, dict(tile=tile, window=k)):
        got = apply_lib.apply_sorted_stream_windowed_plain(
            T(table.copy()), ids_s, upd_s, **plan).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
        if streams == "one":
            t1 = slice(tile, 2 * tile)
            np.testing.assert_array_equal(got[t1], table[t1])


def _jax_window_plan(ids, n, tile, k):
    """``pecanpy_tpu/ops/apply.py``'s windowed plan, as its driver writes
    it (``_finalize_and_run`` pads, :470-471 searchsorts, :384-387)."""
    n_pad = -(-n // tile) * tile
    r_pad = -(-ids.size // k) * k
    ids_p = jnp.pad(jnp.asarray(ids), (0, r_pad - ids.size), constant_values=n_pad)
    edges = jnp.arange(n_pad // tile + 1, dtype=jnp.int32) * tile
    bounds = jnp.searchsorted(ids_p, edges).astype(jnp.int32)
    lo = bounds[:-1]
    w0 = lo // k
    nw = jnp.maximum(-(-(bounds[1:] - w0 * k) // k), 0).astype(jnp.int32)
    nw = jnp.where(bounds[1:] > lo, nw, 0)
    return [np.asarray(a) for a in (bounds, w0, nw)]


@pytest.mark.parametrize("tile,k", [(64, 32), (2048, 512), (16, 8)])
def test_window_plan_equals_jax_formula(tile, k, rng):
    n = 20 * tile + 7  # a ragged last tile
    for ids in (
        np.sort(rng.integers(0, n, 40 * k)),
        np.sort(np.concatenate([rng.integers(0, 3 * tile, 5), np.full(3 * k, 7 * tile)])),
        np.array([n - 1]),
    ):
        ids = ids.astype(np.int32)
        got = apply_lib.window_plan(T(ids), n, tile, k)
        for a, b in zip(got, _jax_window_plan(ids, n, tile, k)):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_plain_bitwise_equals_sorted_plain(dtype, rng):
    """Same stream order, sums from 0, same rounding hash: the windowed
    plain version and ``apply_sorted_stream_plain`` agree bit for bit."""
    n, d = 1000, 13
    ids, upd, _ = _windowed_stream(rng, 64, 256, d)  # hot row of 700
    ids_s = T(np.sort(np.concatenate([ids, rng.integers(0, n, 300)])).astype(np.int32))
    upd = T(rng.normal(size=(ids_s.numel(), d)).astype(np.float32) * 1e-2)
    table = T(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    want = apply_lib.apply_sorted_stream_plain(table.clone(), ids_s, upd, seed=9)
    for plan in ({}, dict(tile=16, window=8), dict(tile=2048, window=512)):
        got = apply_lib.apply_sorted_stream_windowed_plain(table.clone(), ids_s, upd, 9, **plan)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_windowed_plain_drops_out_of_range_ids():
    table = torch.zeros((100, 4))
    ids = torch.tensor([-5, -1, 0, 3, 3, 99, 100, 127, 500], dtype=torch.int32)
    apply_lib.apply_sorted_stream_windowed_plain(table, ids, torch.ones(9, 4))
    want = torch.zeros((100, 4))
    want[0], want[3], want[99] = -1.0, -2.0, -1.0
    assert torch.equal(table, want)


@pytest.mark.parametrize("v2", [False, True])
def test_cpu_tables_never_launch(v2, rng, monkeypatch):
    """With PECANPY_TPU_APPLY_V2 on or off, a CPU table takes the scatter
    path and launches no kernel; the windowed wrapper runs its plain
    version on the CPU."""
    monkeypatch.setattr(apply_lib, "APPLY_V2", v2)
    counts = (apply_lib.apply_sorted_stream.launches,
              apply_lib.apply_sorted_stream_windowed.launches)
    n, d = 40, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids, upd, cnt = _stream(rng, n, d, 90)
    got = apply_mean_updates(T(table.copy()), T(ids), T(upd), T(cnt), 0.05)
    apply_mean_updates_two(got, T(ids), T(upd), T(cnt), T(ids), T(upd), T(cnt), 0.05)
    ids_s, upd_s = apply_lib.sorted_stream_one(T(ids), T(upd), T(cnt), 0.05, 4.0)
    out = apply_lib.apply_sorted_stream_windowed(T(table.copy()), ids_s, upd_s)
    want = apply_lib.apply_sorted_stream_plain(T(table.copy()), ids_s, upd_s)
    assert torch.equal(out, want)
    assert counts == (apply_lib.apply_sorted_stream.launches,
                      apply_lib.apply_sorted_stream_windowed.launches)


@pytest.mark.parametrize("v2,d,windowed", [
    (False, 128, False), (False, 512, False), (True, 128, True), (True, 448, True),
    (True, 449, False), (True, 512, False),
])
def test_cuda_applier_routes_wide_rows_to_kernel_2_1(v2, d, windowed, monkeypatch):
    """Under PECANPY_TPU_APPLY_V2 a table takes the windowed kernel up to
    MAX_WINDOWED_DIM columns and kernel 2.1 (no width limit, bit-equal)
    above it; without the flag always kernel 2.1."""
    monkeypatch.setattr(apply_lib, "APPLY_V2", v2)
    assert apply_lib.MAX_WINDOWED_DIM == 448
    want = (apply_lib.apply_sorted_stream_windowed if windowed
            else apply_lib.apply_sorted_stream)
    assert apply_lib._cuda_applier(torch.empty(0, d)) is want


def _owned_rows_loop(ids, grid):
    """Each block's owned rows by a plain loop over segment heads: a head
    with an id >= 0 belongs to the block whose range ``[b R // grid,
    (b + 1) R // grid)`` holds it, and brings its whole segment along."""
    r = ids.size
    owner = np.full(r, -1)
    head = 0
    while head < r:
        end = head
        while end < r and ids[end] == ids[head]:
            end += 1
        if ids[head] >= 0:
            owner[head:end] = next(b for b in range(grid) if b * r // grid <= head < (b + 1) * r // grid)
        head = end
    return owner


@pytest.mark.parametrize("kind", ["random", "hot", "out_of_range", "one_row", "short"])
def test_windowed_partition_owns_each_row_once(kind, rng):
    """The windowed kernel's partition rule (``windowed_partition``): every
    row of a segment with an id >= 0 lies in exactly one block's range,
    the same block for the whole segment, the one that holds its head;
    rows of ids < 0 in none."""
    n, r = 500, 3000
    ids = np.sort(rng.integers(0, n, r))
    if kind == "hot":
        ids[700:2600] = ids[700]
    elif kind == "out_of_range":
        ids = np.sort(np.concatenate([rng.integers(-40, 0, 900), ids[:1200], np.full(900, n + 3)]))
    elif kind == "one_row":
        ids[:] = 17
    elif kind == "short":
        ids = ids[:40]
    for grid in (1, 7, 132, 5000):
        start, end = apply_lib.windowed_partition(T(ids.astype(np.int32)), grid)
        assert start.shape == end.shape == (grid,)
        owner = np.full(ids.size, -1)
        for b, (lo, hi) in enumerate(zip(start.tolist(), end.tolist())):
            assert lo <= hi
            assert (owner[lo:hi] == -1).all()  # no row in two blocks
            owner[lo:hi] = b
        np.testing.assert_array_equal(owner, _owned_rows_loop(ids, grid))
