"""The CUDA kernels against their plain torch versions, on the card.

The table applier (``csrc/apply.cu``), its windowed variant
(``csrc/apply_v2.cu``, which must equal the first bit for bit) and the two
rejection-trial kernels (``csrc/trial.cu``); the trial kernels must equal
their plain version
(``rejection._trial_block``) bit for bit, with the cdf channel on any
weights and without it on integer weights; without it on float weights
at most 1e-3 of the lanes may differ (the group's prefix sum adds in
another order than ``torch.cumsum``).

These tests need a CUDA device and the CUDA toolkit (``nvcc``); they skip
without a device. They import torch and the port only (no jax), so they
also run on a machine without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: f32 allclose rtol=1e-5, atol=1e-6 (segment sums in another
order than ``index_add_``). bf16: kernel and plain share the rounding
bits, so they agree bit for bit except where the two f32 sums straddle a
rounding boundary; at most ``BF16_MISMATCH_SHARE`` of the touched
elements may differ, each by at most 1 ulp. A kernel that truncated,
rounded to nearest, or hashed another (seed, row, col) would differ in
about half of them. Rows no id names stay bit-equal. The ``long_pass``
tests hold kernel 2.1 to its plain version bit for bit, f32 and bf16:
both add each row's payload in stream order from 0, so the f32 sums and
the rounding bits are the same.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pecanpy_tpu_torch.ops import apply as apply_lib

pytestmark = pytest.mark.gpu

BF16_MISMATCH_SHARE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(n, d, r, seed, device):
    gen = np.random.default_rng(seed)
    ids = np.concatenate([gen.integers(0, n, r - 60), np.full(60, n // 2)])
    ids_s = torch.from_numpy(np.sort(ids).astype(np.int32)).to(device)
    upd_s = torch.from_numpy(gen.normal(size=(r, d)).astype(np.float32) * 1e-3).to(device)
    return ids_s, upd_s


def _ulps(a, b):
    """Elementwise distance in bf16 ulps (sign-magnitude bit patterns
    mapped onto one ordered integer line)."""

    def ordered(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def _assert_bf16_close(got, want, touched):
    if not bool(touched.any()):
        return
    ulps = _ulps(got[touched], want[touched])
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) <= BF16_MISMATCH_SHARE * ulps.numel()


@pytest.mark.parametrize("d", [128, 13, 4, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, d, dtype):
    n, r = 5000, 3000
    table0 = (torch.rand(n, d, device=cuda) - 0.5).to(dtype)
    ids_s, upd_s = _stream(n, d, r, seed=d, device=cuda)
    before = apply_lib.apply_sorted_stream.launches
    got = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, seed=5)
    assert apply_lib.apply_sorted_stream.launches == before + 1
    want = apply_lib.apply_sorted_stream_plain(table0.clone(), ids_s, upd_s, seed=5)
    torch.cuda.synchronize()
    touched = torch.zeros(n, dtype=torch.bool, device=cuda)
    touched[ids_s.long()] = True
    assert torch.equal(got[~touched], table0[~touched])
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        _assert_bf16_close(got, want, touched)


@pytest.mark.parametrize("d", [64, 13])
def test_kernel_bf16_stochastic_rounding_unbiased(cuda, d):
    """The kernel's bf16 writeback: many updates far below one ulp move the
    mean within 3 sigma of the f32 result, and equal the plain version bit
    for bit (one row per id, so the f32 values are exact in both)."""
    n, delta = 4096, 1e-4
    table = torch.ones((n, d), dtype=torch.bfloat16, device=cuda)
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    upd = torch.full((n, d), delta, device=cuda)
    want = apply_lib.apply_sorted_stream_plain(table.clone(), ids, upd, seed=7)
    out = apply_lib.apply_sorted_stream(table, ids, upd, seed=7)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    out = out.to(torch.float64).cpu()
    h = 2.0**-8  # bf16 spacing just below 1.0
    p = delta / h
    sigma = h * np.sqrt(p * (1 - p) / (n * d))
    assert abs(float(out.mean()) - (1.0 - delta)) <= 3 * sigma
    assert set(np.unique(out.numpy())) <= {1.0, 1.0 - h}


@pytest.mark.parametrize("d", [16, 13])
def test_kernel_bf16_representable_values_stay_exact(cuda, d):
    rng = np.random.default_rng(d)
    vals = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    ids = torch.arange(0, 64, 2, dtype=torch.int32, device=cuda)
    zero = apply_lib.apply_sorted_stream(
        vals.clone(), ids, torch.zeros(32, d, device=cuda), seed=3)
    assert torch.equal(zero.view(torch.int16), vals.view(torch.int16))
    # an update that lands exactly on a bf16 value rounds to it exactly
    target = (vals[ids.long()].float() * 0.5).to(torch.bfloat16)
    upd = vals[ids.long()].float() - target.float()
    out = apply_lib.apply_sorted_stream(vals.clone(), ids, upd, seed=3)
    assert torch.equal(out[ids.long()].view(torch.int16), target.view(torch.int16))
    odd = torch.arange(1, 64, 2, device=cuda)
    assert torch.equal(out[odd].view(torch.int16), vals[odd].view(torch.int16))


def test_kernel_edge_cases(cuda):
    table = torch.randn(64, 8, device=cuda)
    keep = table.clone()
    empty = apply_lib.apply_sorted_stream(
        table, torch.empty(0, dtype=torch.int32, device=cuda),
        torch.empty(0, 8, device=cuda),
    )
    assert torch.equal(empty, keep)
    with pytest.raises(TypeError):
        apply_lib.apply_sorted_stream(
            table, torch.zeros(2, dtype=torch.int64, device=cuda),
            torch.zeros(2, 8, device=cuda),
        )
    with pytest.raises(ValueError):
        apply_lib.apply_sorted_stream(
            table, torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.zeros(8, 2, device=cuda).T,  # [2, 8], not contiguous
        )
    # a whole stream of one id: one segment, summed by the long pass;
    # 2^-10 payloads keep every partial sum exact, so only the final
    # subtraction rounds
    ids = torch.full((5000,), 7, dtype=torch.int32, device=cuda)
    upd = torch.full((5000, 8), 2.0**-10, device=cuda)
    apply_lib.apply_sorted_stream(table, ids, upd)
    assert torch.equal(table[7], keep[7] - 5000 * 2.0**-10)
    assert torch.equal(table[:7], keep[:7]) and torch.equal(table[8:], keep[8:])


@pytest.mark.parametrize("d", [8, 13])
@pytest.mark.parametrize("sign", ["positive", "mixed"])
def test_kernel_long_segment_accuracy(cuda, d, sign):
    """The kernel sums each column of a segment serially in f32 (the long
    pass, here), so the error grows with the segment's length n. Held to the serial-summation bound against a
    float64 sum: |err| <= gamma(n - 1) sum|x| plus the final subtraction's
    rounding, with gamma(k) = k u / (1 - k u) and u = 2^-24 the f32 unit
    roundoff."""
    n = 20_000
    rng = np.random.default_rng(n + d)
    upd64 = rng.uniform(0.5, 1.5, size=(n, d)) * 1e-3  # not representable
    if sign == "mixed":
        upd64 *= rng.choice([-1.0, 1.0], size=(n, d))
    upd = torch.from_numpy(upd64.astype(np.float32)).to(cuda)
    upd64 = upd.double().cpu().numpy()  # the f32 payload, exactly
    table = torch.from_numpy(rng.normal(size=(16, d)).astype(np.float32)).to(cuda)
    keep = table.double().cpu().numpy()
    ids = torch.full((n,), 3, dtype=torch.int32, device=cuda)
    apply_lib.apply_sorted_stream(table, ids, upd)
    want = keep[3] - upd64.sum(axis=0)
    u = 2.0**-24
    gamma = (n - 1) * u / (1 - (n - 1) * u)
    bound = gamma * np.abs(upd64).sum(axis=0) + 2 * u * np.abs(want)
    err = np.abs(table[3].double().cpu().numpy() - want)
    assert (err <= bound).all(), (err.max(), bound.min())
    others = np.arange(16) != 3
    np.testing.assert_array_equal(table.cpu().numpy()[others], keep[others])


def test_mean_updates_launch_the_kernel(cuda):
    n, d = 300, 16
    table = torch.randn(n, d, device=cuda)
    ids = torch.randint(0, n, (500,), device=cuda, dtype=torch.int32)
    upd = torch.randn(500, d, device=cuda)
    cnt = torch.ones(500, device=cuda)
    want = apply_lib._apply_scatter(table.clone(), ids, upd, cnt, 0.05, 4.0)
    before = apply_lib.apply_sorted_stream.launches
    got = apply_lib.apply_mean_updates(table, ids, upd, cnt, 0.05, cap=4.0)
    apply_lib.apply_mean_updates_two(
        got, ids, upd, cnt, ids[:0], upd[:0], cnt[:0], 0.0
    )
    assert apply_lib.apply_sorted_stream.launches == before + 2
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)


# -- kernel 2.1's long pass (csrc/apply.cu) -----------------------------------


def _assert_2_1_bitwise(cuda, table0, ids_s, upd_s, seed=9):
    """Kernel 2.1: one counted launch, to the bit the plain version's on the
    stream's rows with ids in [0, N) (the kernel drops the others),
    untouched rows bit-equal."""
    n = table0.shape[0]
    before = apply_lib.apply_sorted_stream.launches
    got = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, seed)
    assert apply_lib.apply_sorted_stream.launches == before + 1
    keep = (ids_s >= 0) & (ids_s < n)
    want = apply_lib.apply_sorted_stream_plain(
        table0.clone(), ids_s[keep].contiguous(), upd_s[keep].contiguous(), seed)
    torch.cuda.synchronize()
    bits = torch.int16 if table0.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    touched = torch.zeros(n, dtype=torch.bool, device=cuda)
    touched[ids_s[keep].long()] = True
    assert torch.equal(got[~touched].view(bits), table0[~touched].view(bits))
    return got


def _long_case(cuda, ids, d, dtype, seed, n=5000, upd_s=None):
    """Kernel 2.1 on the sorted ids ``ids`` into a random [n, d] table."""
    gen = np.random.default_rng(seed)
    ids_s = torch.from_numpy(np.asarray(ids, dtype=np.int32)).to(cuda)
    if upd_s is None:
        upd_s = torch.from_numpy(
            gen.normal(size=(ids_s.numel(), d)).astype(np.float32) * 1e-3).to(cuda)
    table0 = (torch.rand(n, d, device=cuda) - 0.5).to(dtype)
    return _assert_2_1_bitwise(cuda, table0, ids_s, upd_s)


def _with_segment(r, length, seed, n=5000):
    """``r`` sorted ids in [0, n): ``length`` rows of the id n // 3 and
    random ids, none of them n // 3, around them."""
    v = n // 3
    ids = np.random.default_rng(seed).integers(0, n, r - length)
    ids[ids == v] = v + 1
    return np.sort(np.concatenate([ids, np.full(length, v)]))


@pytest.mark.parametrize("length", ["L", "L+1", "2000"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_segment_lengths(cuda, length, dtype):
    """A segment of L rows is the short pass's, one of L + 1 the long
    pass's; both, and a 2,000-row one, to the bit the plain version's."""
    big = apply_lib.long_segment_rows()
    rows = {"L": big, "L+1": big + 1, "2000": 2000}[length]
    _long_case(cuda, _with_segment(6000, rows, seed=rows), 128, dtype, seed=rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_several_segments(cuda, dtype):
    """Several long segments with short ones between them, in three slabs
    of 32 columns."""
    big = apply_lib.long_segment_rows()
    gen = np.random.default_rng(21)
    heads = np.array([500, 1500, 2500, 3500, 4500])
    short = gen.integers(0, 5000, 3000)
    short = short[~np.isin(short, heads)]
    long_ = [np.full(rows, v) for v, rows in zip(heads, [big + 1, 40, 300, 1000, 2 * big + 3])]
    _long_case(cuda, np.sort(np.concatenate([short, *long_])), 96, dtype, seed=21)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_out_of_range_segments(cuda, dtype):
    """Long segments of ids < 0 and >= N are dropped in both passes."""
    big = apply_lib.long_segment_rows()
    gen = np.random.default_rng(22)
    ids = np.sort(np.concatenate([
        np.full(3 * big, -3), np.full(big + 1, -1), gen.integers(0, 5000, 3000),
        np.full(500, 77), np.full(big + 1, 5000), np.full(2000, 5007)]))
    _long_case(cuda, ids, 64, dtype, seed=22)


@pytest.mark.parametrize("length", ["L+1", "600"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_segment_ends_at_r(cuda, length, dtype):
    """The stream's last segment is long; at L + 1 rows its head is the
    last row before R - L."""
    big = apply_lib.long_segment_rows()
    rows = {"L+1": big + 1, "600": 600}[length]
    r = 4000
    ids = np.sort(np.random.default_rng(23).integers(0, 4000, r))
    ids[r - rows:] = 4999
    _long_case(cuda, ids, 128, dtype, seed=23)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_whole_stream_one_id(cuda, dtype):
    _long_case(cuda, np.full(5000, 1234), 64, dtype, seed=24)


@pytest.mark.parametrize("d", [512, 100, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_widths(cuda, d, dtype):
    """D = 512 (16 slabs) and widths that are not a multiple of the slab."""
    ids = _with_segment(7000, 900, seed=d)
    ids[5000:5100] = ids[5000]
    _long_case(cuda, ids, d, dtype, seed=d)


@pytest.mark.parametrize("kind", ["d130", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_pass_unvectorized(cuda, kind, dtype):
    """The 4-byte path (D % 4 != 0, or a payload off 16-byte alignment)
    with long segments."""
    d, r = (130, 5000) if kind == "d130" else (128, 5000)
    ids = _with_segment(r, 1500, seed=25)
    ids[4000:4050] = ids[4000]
    upd_s = None
    if kind == "unaligned":
        gen = np.random.default_rng(25)
        buf = torch.from_numpy(gen.normal(size=r * d + 1).astype(np.float32) * 1e-3).to(cuda)
        upd_s = buf[1:].view(r, d)
        assert upd_s.is_contiguous() and upd_s.data_ptr() % 16 != 0
    _long_case(cuda, ids, d, dtype, seed=25, upd_s=upd_s)


def test_mean_updates_wide_rows_under_apply_v2(cuda, monkeypatch):
    """With APPLY_V2 set, a table wider than MAX_WINDOWED_DIM (here 512)
    runs kernel 2.1 from both entry points, never the windowed kernel,
    and equals the plain version of the same sorted streams."""
    monkeypatch.setattr(apply_lib, "APPLY_V2", True)
    n, d = 3000, 512
    assert d > apply_lib.MAX_WINDOWED_DIM
    gen = np.random.default_rng(26)
    ids = torch.from_numpy(np.concatenate([gen.integers(0, n, 2000),
                                           np.full(400, 17)]).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(gen.normal(size=(2400, d)).astype(np.float32)).to(cuda)
    cnt = torch.ones(2400, device=cuda)
    table = torch.randn(n, d, device=cuda)
    want = table.clone()
    ids_s, upd_s = apply_lib.sorted_stream_one(ids, upd, cnt, 0.05, 4.0)
    apply_lib.apply_sorted_stream_plain(want, ids_s, upd_s, 3)
    ids_s, upd_s = apply_lib.sorted_stream_two(ids, upd, cnt, ids[:7], upd[:7], cnt[:7],
                                               0.05, 4.0, 4.0)
    apply_lib.apply_sorted_stream_plain(want, ids_s, upd_s, 3)
    old = apply_lib.apply_sorted_stream.launches
    before = apply_lib.apply_sorted_stream_windowed.launches
    got = apply_lib.apply_mean_updates(table, ids, upd, cnt, 0.05, cap=4.0, rng_seed=3)
    apply_lib.apply_mean_updates_two(got, ids, upd, cnt, ids[:7], upd[:7], cnt[:7], 0.05,
                                     rng_seed=3)
    torch.cuda.synchronize()
    assert apply_lib.apply_sorted_stream.launches == old + 2
    assert apply_lib.apply_sorted_stream_windowed.launches == before
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- the stream prep (sorted_stream_one / _two) at the benchmark's sizes --------


def _scan_scales(keys_s, cnt_s, lr, cap):
    """The group scales as masked scans compute them (the JAX package's
    formula, in torch): the reference the prep's self-search is held to,
    here and in ``test_torch_apply.py``."""
    cnt_f = cnt_s.to(torch.float32)
    cum = torch.cumsum(cnt_f, dim=0)
    change = keys_s[1:] != keys_s[:-1]
    true1 = torch.ones(1, dtype=torch.bool, device=keys_s.device)
    start = torch.cat([true1, change])
    end = torch.cat([change, true1])
    inf = float("inf")
    seg_lo = torch.cummax(torch.where(start, cum - cnt_f, -inf), dim=0).values
    seg_hi = torch.cummin(torch.where(end, cum, inf).flip(0), dim=0).values.flip(0)
    tot = seg_hi - seg_lo
    if isinstance(cap, torch.Tensor):
        capped = torch.minimum(tot, cap)
    else:
        capped = torch.clamp(tot, max=cap)
    return lr * capped / torch.clamp(tot, min=1e-9)


def _sgns_stream(gen, r, n, d, max_cnt, device):
    """A stream shaped as an SGNS chunk-step's: ids over n nodes, a tenth
    of them on 50 hot rows, integer counts, f32 payload rows."""
    ids = np.where(gen.random(r) < 0.1, gen.integers(0, 50, r), gen.integers(0, n, r))
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(gen.normal(size=(r, d)).astype(np.float32)).to(device),
            torch.from_numpy(gen.integers(0, max_cnt + 1, r).astype(np.float32)).to(device))


@pytest.mark.parametrize("merged", [False, True])
def test_stream_prep_equals_scans_at_benchmark_size(cuda, merged):
    """The W_in stream (R = 100,035: 1,235 walks of 81 tokens) and the
    W_out stream (the same plus a 32,768-slot negative pool): ``ids_s``
    and ``upd_s`` bit-equal to the scan formula's, and no host-device
    sync in the prep."""
    gen = np.random.default_rng(27)
    n, d, lr = 1_000_000, 128, 0.025
    ids, upd, cnt = _sgns_stream(gen, 100_035, n, d, 20, cuda)
    if merged:
        ids_b, upd_b, cnt_b = _sgns_stream(gen, 32_768, n, d, 200, cuda)
        keys = torch.cat([ids.to(torch.int64) * 2, ids_b.to(torch.int64) * 2 + 1])
        keys_s, order = torch.sort(keys, stable=True)
        cap_s = torch.where((keys_s & 1) == 1, 1.0, 4.0)
        scale = _scan_scales(keys_s, torch.cat([cnt, cnt_b])[order], lr, cap_s)
        want_ids = (keys_s >> 1).to(torch.int32)
        want_upd = torch.cat([upd, upd_b])[order] * scale[:, None]
    else:
        want_ids, order = torch.sort(ids, stable=True)
        scale = _scan_scales(want_ids, cnt[order], lr, 4.0)
        want_upd = upd[order] * scale[:, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if merged:
            ids_s, upd_s = apply_lib.sorted_stream_two(ids, upd, cnt, ids_b, upd_b, cnt_b,
                                                       lr, 4.0, 1.0)
        else:
            ids_s, upd_s = apply_lib.sorted_stream_one(ids, upd, cnt, lr, 4.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(ids_s, want_ids)
    assert torch.equal(upd_s.view(torch.int32), want_upd.view(torch.int32))


# -- the windowed applier (csrc/apply_v2.cu) ----------------------------------


def _assert_windowed(cuda, table0, ids_s, upd_s, seed):
    """The windowed kernel: one launch, bit-equal to kernel 2.1 (both sum
    each row in stream order from 0 and share the rounding hash), within
    2.1's tolerances of its plain version, untouched rows bit-equal."""
    before = apply_lib.apply_sorted_stream_windowed.launches
    got = apply_lib.apply_sorted_stream_windowed(table0.clone(), ids_s, upd_s, seed)
    launched = apply_lib.apply_sorted_stream_windowed.launches - before
    assert launched == int(ids_s.numel() > 0)
    ref = apply_lib.apply_sorted_stream(table0.clone(), ids_s, upd_s, seed)
    want = apply_lib.apply_sorted_stream_windowed_plain(table0.clone(), ids_s, upd_s, seed)
    torch.cuda.synchronize()
    bits = torch.int16 if table0.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))
    n = table0.shape[0]
    ids = ids_s.long()
    touched = torch.zeros(n, dtype=torch.bool, device=cuda)
    touched[ids[(ids >= 0) & (ids < n)]] = True
    assert torch.equal(got[~touched].view(bits), table0[~touched].view(bits))
    if table0.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        _assert_bf16_close(got, want, touched)
    return got


@pytest.mark.parametrize("d", [128, 13, 4, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_matches_2_1_and_plain(cuda, d, dtype):
    n, r = 5000, 3000  # 60 copies of one id: a segment across windows
    table0 = (torch.rand(n, d, device=cuda) - 0.5).to(dtype)
    ids_s, upd_s = _stream(n, d, r, seed=d, device=cuda)
    _assert_windowed(cuda, table0, ids_s, upd_s, seed=11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_hot_row_and_bounds(cuda, dtype):
    """A hot row of 5,000 entries spanning many windows and starting off a
    window boundary, neighbours on both sides of tile edges, a tile whose
    slice is empty, and the table's ragged last tile."""
    n, d = 64 * 40 + 17, 24
    gen = np.random.default_rng(5)
    ids = np.concatenate([
        gen.integers(0, n, 2000), np.full(5000, 64 * 7 + 63), np.full(31, 64 * 8),
        [n - 1, n - 1, 64 * 39], np.arange(64 * 12, 64 * 13),
    ])
    ids = ids[(ids < 64 * 20) | (ids >= 64 * 21)]  # tile 20 untouched
    ids_s = torch.from_numpy(np.sort(ids).astype(np.int32)).to(cuda)
    upd_s = torch.from_numpy(gen.normal(size=(ids.size, d)).astype(np.float32) * 1e-3).to(cuda)
    table0 = (torch.rand(n, d, device=cuda) - 0.5).to(dtype)
    got = _assert_windowed(cuda, table0, ids_s, upd_s, seed=2)
    assert not torch.equal(got[64 * 7 + 63], table0[64 * 7 + 63])


def test_windowed_kernel_edge_cases(cuda):
    """An empty stream, one row, ids outside [0, N) (dropped, never written),
    and what the wrapper refuses."""
    table0 = torch.randn(300, 8, device=cuda)
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    _assert_windowed(cuda, table0, empty, torch.empty(0, 8, device=cuda), 0)
    one = torch.tensor([17], dtype=torch.int32, device=cuda)
    got = _assert_windowed(cuda, table0, one, torch.ones(1, 8, device=cuda), 0)
    assert torch.equal(got[17], table0[17] - 1.0)
    ids = torch.tensor([-7, -1, 0, 299, 300, 319, 320, 10**6], dtype=torch.int32, device=cuda)
    table = table0.clone()
    apply_lib.apply_sorted_stream_windowed(table, ids, torch.ones(8, 8, device=cuda))
    torch.cuda.synchronize()
    want = table0.clone()
    want[0] -= 1.0
    want[299] -= 1.0
    assert torch.equal(table, want)
    with pytest.raises(TypeError):
        apply_lib.apply_sorted_stream_windowed(
            table, torch.zeros(2, dtype=torch.int64, device=cuda), torch.zeros(2, 8, device=cuda))
    with pytest.raises(ValueError, match="at most"):
        apply_lib.apply_sorted_stream_windowed(
            torch.zeros(4, 1024, device=cuda), one, torch.zeros(1, 1024, device=cuda))


def _random_stream(n, r, seed):
    gen = np.random.default_rng(seed)
    return np.sort(gen.integers(0, n, r)), gen


def _windowed_case(cuda, ids, d, dtype, gen, upd_s=None):
    ids_s = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    if upd_s is None:
        upd_s = torch.from_numpy(gen.normal(size=(ids.size, d)).astype(np.float32) * 1e-3).to(cuda)
    n = 5000
    table0 = (torch.rand(n, d, device=cuda) - 0.5).to(dtype)
    return _assert_windowed(cuda, table0, ids_s, upd_s, seed=13)


def _block_starts(cuda, d, dtype, r):
    """The first stream row of each block's range, as the launcher splits
    R rows over its grid."""
    grid = apply_lib.windowed_grid(torch.empty(1, d, device=cuda, dtype=dtype),
                                   torch.empty(1, d, device=cuda))
    return [b * r // grid for b in range(grid + 1)]


@pytest.mark.parametrize("blocks", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_segment_across_blocks(cuda, blocks, dtype):
    """One segment that starts inside block 0's range and runs into the
    ranges of ``blocks - 1`` more blocks: its owner finishes it, and the
    blocks whose ranges it covers skip it."""
    d, r = 24, 60_000
    s = _block_starts(cuda, d, dtype, r)
    assert s[2] - s[1] >= 16  # ranges wider than a window
    ids, gen = _random_stream(5000, r, blocks)
    a, b = s[1] - 7, s[blocks - 1] + 9
    ids[a:b] = ids[a]  # still sorted
    _windowed_case(cuda, ids, d, dtype, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_fewer_rows_than_blocks(cuda, dtype):
    r = 100
    assert len(_block_starts(cuda, 8, dtype, r)) - 1 > r
    ids, gen = _random_stream(5000, r, 3)
    ids[40:47] = ids[40]
    _windowed_case(cuda, ids, 8, dtype, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_one_table_row(cuda, dtype):
    """Every id names one row: block 0 owns the whole stream."""
    ids = np.full(20_000, 4321)
    got = _windowed_case(cuda, ids, 16, dtype, np.random.default_rng(4))
    assert int(got.shape[0]) == 5000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_only_out_of_range_ids(cuda, dtype):
    """Every id < 0 or >= N: nothing is written."""
    ids = np.sort(np.concatenate([np.full(3000, -4), np.arange(-900, 0), np.full(2000, 5000),
                                  np.arange(5001, 9000)]))
    _windowed_case(cuda, ids, 16, dtype, np.random.default_rng(5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_widest_row(cuda, dtype):
    """D = MAX_WINDOWED_DIM: the shared-memory ceiling of the kernel's ring
    (four columns a thread)."""
    ids, gen = _random_stream(5000, 6000, 6)
    ids[100:400] = ids[100]
    _windowed_case(cuda, ids, apply_lib.MAX_WINDOWED_DIM, dtype, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_unaligned_payload(cuda, dtype):
    """A contiguous payload view 4 bytes off 16-byte alignment: the kernel
    takes its 4-byte copies."""
    d, r = 128, 7000
    ids, gen = _random_stream(5000, r, 7)
    ids[10:90] = ids[10]
    buf = torch.from_numpy(gen.normal(size=r * d + 1).astype(np.float32) * 1e-3).to(cuda)
    upd_s = buf[1:].view(r, d)
    assert upd_s.is_contiguous() and upd_s.data_ptr() % 16 != 0
    _windowed_case(cuda, ids, d, dtype, gen, upd_s=upd_s)


def test_mean_updates_route_to_the_windowed_kernel(cuda, monkeypatch):
    """With APPLY_V2 set, both entry points launch the windowed kernel and
    never kernel 2.1."""
    monkeypatch.setattr(apply_lib, "APPLY_V2", True)
    n, d = 300, 16
    table = torch.randn(n, d, device=cuda)
    ids = torch.randint(0, n, (500,), device=cuda, dtype=torch.int32)
    upd = torch.randn(500, d, device=cuda)
    cnt = torch.ones(500, device=cuda)
    want = apply_lib._apply_scatter(table.clone(), ids, upd, cnt, 0.05, 4.0)
    old = apply_lib.apply_sorted_stream.launches
    before = apply_lib.apply_sorted_stream_windowed.launches
    got = apply_lib.apply_mean_updates(table, ids, upd, cnt, 0.05, cap=4.0)
    apply_lib.apply_mean_updates_two(got, ids, upd, cnt, ids[:0], upd[:0], cnt[:0], 0.0)
    assert apply_lib.apply_sorted_stream_windowed.launches == before + 2
    assert apply_lib.apply_sorted_stream.launches == old
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)


# -- the rejection-trial kernels (csrc/trial.cu) ------------------------------

# the degrees the kernels' row reads turn on: a dead row, rows that end
# inside, at and just past the first 32-slot head, a full row (dpad = the
# cap, 64), and hubs (above the cap)
EDGE_DEGREES = (0, 1, 31, 32, 33, 64, 100, 150)
DEGREE_CAP = 64


def degree_graph(seed, n=240, float_weights=False):
    """Directed graph whose first nodes have the out-degrees of
    ``EDGE_DEGREES`` (node 0 has none), the rest 1..64, and the last node
    a hub; integer weights 1..3 (exact prefix sums) or float weights.
    Degree cap ``DEGREE_CAP``: rows are 64 slots wide."""
    gen = np.random.default_rng(seed)
    deg = np.concatenate([EDGE_DEGREES, gen.integers(1, DEGREE_CAP + 1, n - len(EDGE_DEGREES))])
    deg[-1] = 120
    adj = np.zeros((n, n))
    for i, d in enumerate(deg):
        nbrs = gen.choice(np.delete(np.arange(n), i), int(d), replace=False)
        adj[i, nbrs] = gen.integers(1, 4, int(d)) + (gen.random(int(d)) if float_weights else 0)
    return adj


def degree_lanes(adj, b, seed):
    """[B] int32 (cur, prev) lanes over ``degree_graph``: every node of
    ``EDGE_DEGREES`` and node N - 1 as cur and as prev (the dead node 0
    too), then random lanes, half of them with prev an in-neighbor of cur."""
    gen = np.random.default_rng(seed)
    n = adj.shape[0]
    special = np.array([*range(len(EDGE_DEGREES)), n - 1])
    cur = gen.integers(0, n, b)
    prev = gen.integers(0, n, b)
    k = special.size
    cur[:k], prev[k:2 * k] = special, special
    for i in range(2 * k, b, 2):
        into = np.nonzero(adj[:, cur[i]])[0]
        if into.size:
            prev[i] = gen.choice(into)
    return cur.astype(np.int32), prev.astype(np.int32)


def _hub_graph(seed, n=300, directed=False, float_weights=False):
    """Random graph with integer weights 1..3 (exact prefix sums) or float
    weights, degree cap at the median degree: about half the nodes are hubs."""
    gen = np.random.default_rng(seed)
    adj = (gen.random((n, n)) < 0.06).astype(np.float64)
    if not directed:
        adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    w = gen.integers(1, 4, (n, n)) + (gen.random((n, n)) if float_weights else 0)
    adj = adj * (w if directed else np.triu(w) + np.triu(w, 1).T)
    for i in np.nonzero(adj.sum(1) == 0)[0]:
        adj[i, (i + 1) % n] = 1.0
    cap = int(np.median((adj > 0).sum(1)))
    return adj, cap


def _lane_state(dg, cur_t, prev_t, trials, seed, p, q):
    """The round's draws and the atom's (theta, wp) for the lanes."""
    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.ops import rejection

    cur_rows = dg.gather_rows(cur_t)
    draws = engine.TrialDrawStream(seed, 0, trials, cur_t.device)(0, dg.rows_degree(cur_rows))
    alpha_np = max(1.0, 1.0 / q)
    excess = 1.0 / p - alpha_np
    theta = wp = None
    if excess > 0:
        _, wp = rejection.membership(dg, prev_t, cur_rows)
        theta = engine._theta_from(dg, wp, cur_rows, excess, alpha_np)
    return draws, alpha_np, theta, wp


def _trial_inputs(cuda, adj, cap, b, trials, use_cdf, seed, p=0.5, q=2.0, hub_lanes=True):
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    dg = device_csr_from_dense(adj, degree_cap=cap, with_cdf=use_cdf, device=cuda)
    gen = np.random.default_rng(seed)
    capped = (adj > 0).sum(1) <= cap
    # (cur, prev) edges; without hub lanes both ends are capped nodes
    cu, pr = np.nonzero(adj.T)  # every edge prev -> cur
    keep = np.ones(cu.size, bool) if hub_lanes else capped[cu] & capped[pr]
    pick = gen.choice(np.nonzero(keep)[0], b)
    cur_t = torch.from_numpy(cu[pick].astype(np.int32)).to(cuda)
    prev_t = torch.from_numpy(pr[pick].astype(np.int32)).to(cuda)
    draws, alpha_np, theta, wp = _lane_state(dg, cur_t, prev_t, trials, seed, p, q)
    return dg, draws, prev_t, cur_t, alpha_np, theta, wp


def _plain_block(dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf=False, force_ok=None):
    from pecanpy_tpu_torch.ops import rejection

    return rejection._trial_block(
        dg, draws.trials(), prev, dg.gather_rows(cur), dg.gather_rows(prev), p, q, False,
        alpha_np, theta, wp, use_cdf=use_cdf, force_ok=force_ok)


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def _assert_halves_match_plain(dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf,
                               force_ok):
    """Each kernel against its own plain half, bit for bit."""
    from pecanpy_tpu_torch.ops import trialkernel

    x, wx = trialkernel.trial_propose(dg, draws, prev, cur, theta, wp, use_cdf)
    _assert_bitwise((x, wx), trialkernel.trial_propose_plain(
        dg, draws, prev, cur, theta, wp, use_cdf))
    _assert_bitwise(
        trialkernel.trial_accept(dg, draws, x, wx, prev, p, q, alpha_np,
                                 theta is not None, force_ok),
        trialkernel.trial_accept_plain(dg, draws, x, wx, prev, p, q,
                                       alpha_np, theta is not None, force_ok))


@pytest.mark.parametrize("trials", [1, 2, 3])
@pytest.mark.parametrize("p,q", [(0.5, 2.0), (2.0, 0.3)])  # atom on / off
@pytest.mark.parametrize("use_cdf", [True, False])
def test_trial_kernels_match_plain(cuda, trials, p, q, use_cdf):
    from pecanpy_tpu_torch.ops import trialkernel

    adj, cap = _hub_graph(trials)
    b = 1001  # not a multiple of the lanes per block
    dg, draws, prev, cur, alpha_np, theta, wp = _trial_inputs(
        cuda, adj, cap, b, trials, use_cdf, seed=trials, p=p, q=q)
    is_hub = dg.rows_is_hub(dg.gather_rows(cur))
    assert 0 < int(is_hub.sum()) < b
    assert 0 < int(dg.rows_is_hub(dg.gather_rows(prev)).sum()) < b
    force_ok = torch.rand(b, device=cuda) < 0.2
    for force in (None, force_ok):
        n_p, n_a = trialkernel.trial_propose.launches, trialkernel.trial_accept.launches
        got = trialkernel.trial_block_fused(
            dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf=use_cdf, force_ok=force)
        torch.cuda.synchronize()
        assert trialkernel.trial_propose.launches == n_p + 1
        assert trialkernel.trial_accept.launches == n_a + 1
        want = _plain_block(dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf, force)
        _assert_bitwise(got, want)
    _assert_halves_match_plain(dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf,
                               force_ok)


@pytest.mark.parametrize("trials", [1, 8])
@pytest.mark.parametrize("use_cdf", [True, False])
def test_trial_kernels_row_degrees(cuda, trials, use_cdf):
    """Rows of degree 0, 1, 31, 32, 33 and dpad, hubs, and node N - 1, as
    cur and as prev, on 1001 lanes (not a multiple of the lanes per
    block); integer weights, so bit-equal with and without the cdf
    channel."""
    from pecanpy_tpu_torch.ops import trialkernel
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    adj = degree_graph(trials)
    dg = device_csr_from_dense(adj, degree_cap=DEGREE_CAP, with_cdf=use_cdf, device=cuda)
    assert dg.dpad == DEGREE_CAP and dg.has_hubs
    cur_np, prev_np = degree_lanes(adj, 1001, seed=trials)
    cur = torch.from_numpy(cur_np).to(cuda)
    prev = torch.from_numpy(prev_np).to(cuda)
    p, q = 0.5, 2.0
    draws, alpha_np, theta, wp = _lane_state(dg, cur, prev, trials, trials, p, q)
    force_ok = torch.rand(cur.numel(), device=cuda) < 0.2
    for force in (None, force_ok):
        got = trialkernel.trial_block_fused(
            dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf=use_cdf, force_ok=force)
        torch.cuda.synchronize()
        _assert_bitwise(got, _plain_block(
            dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf, force))
    _assert_halves_match_plain(dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf,
                               force_ok)
    # the dead node's lanes pick its padding (nbr N, weight 0)
    x, wx = trialkernel.trial_propose(dg, draws, prev, cur, None, None, use_cdf)
    dead = cur == 0
    assert bool((x[:, dead] == dg.num_nodes).all()) and bool((wx[:, dead] == 0).all())


def test_trial_kernels_no_hub_lanes(cuda):
    """A batch whose cur and prev rows are all capped: no table index is
    computed from a capped row's neighbor slots (a fault if it were)."""
    from pecanpy_tpu_torch.ops import trialkernel

    adj, cap = _hub_graph(7)
    dg, draws, prev, cur, alpha_np, theta, wp = _trial_inputs(
        cuda, adj, cap, 777, 2, False, seed=7, hub_lanes=False)
    assert not bool(dg.rows_is_hub(dg.gather_rows(cur)).any())
    got = trialkernel.trial_block_fused(dg, draws, prev, cur, 0.5, 2.0, alpha_np, theta, wp)
    torch.cuda.synchronize()
    _assert_bitwise(got, _plain_block(dg, draws, prev, cur, 0.5, 2.0, alpha_np, theta, wp))


def test_trial_kernels_float_weights_with_cdf(cuda):
    """With the cdf channel, kernel and plain read the same floats and agree
    bit for bit on float weights too."""
    from pecanpy_tpu_torch.ops import trialkernel

    adj, cap = _hub_graph(3, float_weights=True, directed=True)
    dg, draws, prev, cur, alpha_np, theta, wp = _trial_inputs(
        cuda, adj, cap, 4096, 2, True, seed=3)
    got = trialkernel.trial_block_fused(
        dg, draws, prev, cur, 0.5, 2.0, alpha_np, theta, wp, use_cdf=True)
    _assert_bitwise(got, _plain_block(
        dg, draws, prev, cur, 0.5, 2.0, alpha_np, theta, wp, use_cdf=True))


def test_trial_kernels_float_weights_without_cdf(cuda):
    """Without the cdf channel the group's prefix sum adds in another order
    than torch.cumsum: on float weights at most 1e-3 of the lanes may
    differ (a draw next to a category boundary), and the rest are equal."""
    from pecanpy_tpu_torch.ops import trialkernel
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    adj = degree_graph(4, float_weights=True)
    dg = device_csr_from_dense(adj, degree_cap=DEGREE_CAP, device=cuda)
    cur_np, prev_np = degree_lanes(adj, 16384, seed=4)
    cur = torch.from_numpy(cur_np).to(cuda)
    prev = torch.from_numpy(prev_np).to(cuda)
    draws, alpha_np, theta, wp = _lane_state(dg, cur, prev, 2, 4, 0.5, 2.0)
    got = trialkernel.trial_block_fused(dg, draws, prev, cur, 0.5, 2.0, alpha_np, theta, wp)
    want = _plain_block(dg, draws, prev, cur, 0.5, 2.0, alpha_np, theta, wp)
    differ = torch.stack([a != b for a, b in zip(got, want)]).any(0)
    assert int(differ.sum()) <= 1e-3 * cur.numel()


@pytest.mark.parametrize("queued", [True, False])
def test_hub_engines_launch_the_trial_kernels(cuda, queued):
    """Every round of both hub engines launches each trial kernel once."""
    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.ops import trialkernel
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    adj, cap = _hub_graph(11, float_weights=True)
    dg = device_csr_from_dense(adj, degree_cap=cap, with_cdf=True, device=cuda)
    start = torch.arange(adj.shape[0], dtype=torch.int32, device=cuda).repeat(4)
    draws = engine.TrialDrawStream(0, 0, 2, cuda)
    n_p, n_a = trialkernel.trial_propose.launches, trialkernel.trial_accept.launches
    if queued:
        walks, eff, rounds = engine.generate_walks_queued(
            dg, start, draws, 12, 0.5, 2.0, False, lanes=256, return_rounds=True)
    else:
        walks, eff, rounds = engine.generate_walks_amortized(
            dg, start, draws, 12, 0.5, 2.0, False, return_rounds=True)
    torch.cuda.synchronize()
    assert rounds > 0
    assert trialkernel.trial_propose.launches - n_p == rounds
    assert trialkernel.trial_accept.launches - n_a == rounds
    w, e = walks.cpu().numpy(), eff.cpu().numpy()
    for row, m in zip(w, e):
        assert all(adj[a, b] != 0 for a, b in zip(row[: m - 1], row[1:m]))


def test_trial_kernels_at_draw_boundaries(cuda):
    """Draws placed exactly on the decision boundaries, where a random draw
    almost never lands: u_small on a cdf value (``<`` against ``<=`` in
    the CDF count) and u_acc on the accept probability or one ulp below
    it. At p = 0.9, q = 0.3, alpha / alpha_np and alpha * (1 / alpha_np)
    differ in the last bit, so a kernel that multiplied by the reciprocal
    would flip accept bits here."""
    from pecanpy_tpu_torch.ops import rejection, trialkernel

    p, q = 0.9, 0.3
    adj, cap = _hub_graph(5)
    dg, draws, prev, cur, alpha_np, theta, wp = _trial_inputs(
        cuda, adj, cap, 2048, 1, True, seed=5, p=p, q=q)
    assert theta is None
    cur_rows = dg.gather_rows(cur)
    is_hub = dg.rows_is_hub(cur_rows)
    on_cdf = torch.where(is_hub, 0.5, dg.rows_cdf(cur_rows)[:, 1])
    d = draws.trials()[0]._replace(u_small=on_cdf)
    one = rejection.RoundDraws.stack([d])
    x_p, wx_p = trialkernel.trial_propose_plain(dg, one, prev, cur, use_cdf=True)
    x, wx = trialkernel.trial_propose(dg, one, prev, cur, use_cdf=True)
    _assert_bitwise((x, wx), (x_p, wx_p))
    alpha = rejection._bias(dg, x[0], wx[0], prev, None, dg.gather_rows(prev), p, q, False)
    accept = alpha / torch.full_like(alpha, alpha_np)
    assert bool((accept != alpha * (1.0 / alpha_np)).any())
    below = torch.arange(accept.numel(), device=cuda) % 2 == 1
    u_acc = torch.where(below, torch.nextafter(accept, torch.zeros_like(accept)), accept)
    one = rejection.RoundDraws.stack([d._replace(u_acc=u_acc)])
    got = trialkernel.trial_accept(dg, one, x, wx, prev, p, q, alpha_np, False)
    want = trialkernel.trial_accept_plain(dg, one, x, wx, prev, p, q, alpha_np, False)
    _assert_bitwise(got, want)
    assert torch.equal(got[1], below)


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (2.0, 0.3)])  # atom on / off
def test_step_sampler_kernel_route_matches_plain(cuda, p, q):
    """The per-step sampler with its phases on the trial kernels equals
    the sampler with ``trial_block_fused`` replaced by the kernels' plain
    halves, same draws, integer weights: the same samples and the same
    sweeps, with kernel launches counted."""
    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.ops import rejection, trialkernel
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense
    from pecanpy_tpu_torch.utils import trace

    adj, cap = _hub_graph(23)
    dg = device_csr_from_dense(adj, degree_cap=cap, device=cuda)
    assert dg.has_hubs and "cdf" not in dg.channels
    cu, pr = np.nonzero(adj.T)  # every edge prev -> cur
    pick = np.random.default_rng(23).choice(cu.size, 2048)
    cur = torch.from_numpy(cu[pick].astype(np.int32)).to(cuda)
    prev = torch.from_numpy(pr[pick].astype(np.int32)).to(cuda)
    cur_rows, prev_rows = dg.gather_rows(cur), dg.gather_rows(prev)
    active = dg.rows_is_hub(cur_rows) | dg.rows_is_hub(prev_rows)
    fused = trialkernel.trial_block_fused

    def plain_block(dg, draws, prev, cur, p, q, alpha_np, theta=None, wp=None):
        x, wx = trialkernel.trial_propose_plain(dg, draws, prev, cur, theta, wp)
        return trialkernel.trial_accept_plain(dg, draws, x, wx, prev, p, q, alpha_np,
                                              theta is not None)

    outs = []
    for block in (fused, plain_block):
        draws = engine.SamplerDrawStream(5, 0, cuda)
        before = trialkernel.trial_propose.launches
        trialkernel.trial_block_fused = block
        try:
            with trace.job("pecanpy.test.sample"):
                nxt = rejection.second_order_sample(
                    dg, draws, cur, prev, cur_rows, prev_rows, p, q, False, active)
            outs.append((nxt, trace.last_job("pecanpy.test.sample").counter("walk.sweeps")))
        finally:
            trialkernel.trial_block_fused = fused
        launched = trialkernel.trial_propose.launches - before
        assert (launched > 0) == (block is fused)
    (got, sweeps), (want, sweeps_plain) = outs
    assert sweeps == sweeps_plain and 0 < sweeps < rejection.SWEEP_CAP
    assert torch.equal(got[active], want[active])
    c, x = cur[active].cpu().numpy(), got[active].cpu().numpy()
    assert (adj[c, x] != 0).all()


def test_move_forward_kernel_route_matches_plain(cuda, monkeypatch):
    """``get_move_forward`` on a hub graph with the cdf channel, one lane a
    call: its trial blocks on the kernels equal the plain route
    (``use_trial_kernels`` off) on the same seed over 200 calls, integer
    weights; the kernels launch only on the kernel route."""
    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.ops import rejection, trialkernel

    adj, cap = _hub_graph(31)
    cu, pr = np.nonzero(adj.T)  # every edge prev -> cur
    pick = np.random.default_rng(31).choice(cu.size, 200)
    hub = (adj != 0).sum(1) > cap
    assert hub[cu[pick]].any() and hub[pr[pick]].any()

    def run():
        g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(adj.shape[0])], p=0.5,
                                       q=2.0, degree_cap=cap, random_state=8, device=cuda)
        dg = g.get_device_graph()
        assert dg.has_hubs and "cdf" in dg.channels
        move_forward = g.get_move_forward()
        before = trialkernel.trial_propose.launches
        out = [move_forward(int(c), int(p)) for c, p in zip(cu[pick], pr[pick])]
        return out, trialkernel.trial_propose.launches - before

    got, launched = run()
    monkeypatch.setattr(rejection, "use_trial_kernels", lambda extend, dg: False)
    want, launched_plain = run()
    assert launched > 0 and launched_plain == 0
    assert got == want
    assert (adj[cu[pick], got] != 0).all()


def test_resume_byte_equal_on_the_card(cuda, tmp_path):
    """``embed`` split by ``max_steps`` and resumed from its checkpoint
    ends byte-equal to an uninterrupted run, bf16 tables on the card."""
    from pecanpy_tpu_torch import pecanpy

    adj, _ = _hub_graph(29, n=200, float_weights=True)
    kw = dict(dim=16, num_walks=4, walk_length=10, window_size=3, epochs=2,
              batch_walks=64, table_dtype="bfloat16")

    def embed(**extra):
        g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(200)], p=0.5,
                                       q=2.0, random_state=3, device=cuda)
        return g.embed(**kw, **extra)

    full = embed()
    ckdir = str(tmp_path / "ck")
    partial = embed(checkpoint_dir=ckdir, checkpoint_every=5, max_steps=7)
    assert not np.array_equal(partial, full)
    resumed = embed(checkpoint_dir=ckdir, checkpoint_every=5)
    assert resumed.tobytes() == full.tobytes()


# -- the multi-rank path: 2 gloo ranks sharing the card --------------------------


def _host_hub_graph(seed, n=300):
    """A float-weight hub graph's host layout with the cdf channel."""
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    adj, cap = _hub_graph(seed, n=n, float_weights=True)
    return adj, device_csr_from_dense(adj, degree_cap=cap, with_cdf=True, device="cpu")


@pytest.mark.parametrize("exchange", ["psum", "alltoall"])
def test_collective_fetch_two_ranks_on_one_card(cuda, exchange):
    """Each rank's rows fetched through the row-sharded table (CUDA tensors
    staged through gloo) are the rows a local gather returns, to the bit."""
    from pecanpy_tpu_torch.parallel import distgraph, launch

    _, host = _host_hub_graph(41)
    idx = np.random.default_rng(0).integers(0, 300, (2, 4096)).astype(np.int32)
    calls = [(distgraph.fetch_rows, (host,), dict(idx=idx, exchange=exchange))]
    got = [r[0] for r in launch.spawn(launch.run_calls, 2, (calls,), device="cuda",
                                      backend="gloo")]
    want = host.fused[torch.from_numpy(idx).long()]
    for d in range(2):
        assert got[d].device.type == "cuda"
        assert torch.equal(got[d].cpu().view(torch.int32), want[d].view(torch.int32))


@pytest.mark.parametrize("hubs", [False, True])
def test_multirank_step_edge_equals_replicated_bf16(cuda, hubs):
    """One fused step on 2 ranks sharing the card, bf16 tables: the edge
    partition (plain trial block on fetched rows) equals the replicated one
    (trial kernels on a hub graph) to the bit."""
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense
    from pecanpy_tpu_torch.parallel import launch, train

    if hubs:
        adj, host = _host_hub_graph(43)
    else:
        adj = (np.random.default_rng(5).random((300, 300)) < 0.03).astype(float)
        adj = np.maximum(adj, adj.T)
        np.fill_diagonal(adj, 0)
        adj[np.arange(300), (np.arange(300) + 1) % 300] = 1.0
        host = device_csr_from_dense(adj, device="cpu")
    n = adj.shape[0]
    gen = np.random.default_rng(0)
    config = sgns.SGNSConfig(dim=32, window=3, negative=2, seed=0, table_dtype="bfloat16")
    kw = dict(graph=host, config=config, walk_length=10,
              tables=tuple((gen.standard_normal((n, 32)) * 0.1).astype(np.float32)
                           for _ in range(2)),
              starts=np.arange(n, dtype=np.int32).repeat(2), keep_prob=np.ones(n, np.float32),
              neg_table=np.arange(n, dtype=np.int32), lr=0.025, p=0.5, q=2.0, seed=3)
    calls = [(train.run_fused_step, (), dict(kw, partition=part))
             for part in ("replicated", "edge")]
    rep, edge = launch.spawn(launch.run_calls, 2, (calls,), device="cuda", backend="gloo")[0]
    for k in ("w_in", "w_out", "counts"):
        assert rep[k].tobytes() == edge[k].tobytes()
    assert not np.array_equal(rep["w_out"], kw["tables"][1])


def test_trial_route_off_under_edge(cuda):
    """The trial kernels run on a graph held whole on the card and never on
    a row-sharded one (or for node2vec+, or on the CPU)."""
    from types import SimpleNamespace

    from pecanpy_tpu_torch.ops import rejection
    from pecanpy_tpu_torch.ops.layout import host_graph, to_device
    from pecanpy_tpu_torch.parallel.distgraph import ShardedDeviceCSR

    _, host = _host_hub_graph(47)
    card = to_device(host, cuda)
    assert rejection.use_trial_kernels(False, card)
    assert not rejection.use_trial_kernels(True, card)
    assert not rejection.use_trial_kernels(False, host_graph(card))
    group = SimpleNamespace(all_reduce=lambda t: t, size=1, rank=0)
    sharded = ShardedDeviceCSR(**{f.name: getattr(card, f.name)
                                  for f in dataclasses.fields(card)},
                               global_nodes=card.num_nodes, group=group)
    assert not rejection.use_trial_kernels(False, sharded)


# -- the SGNS step body as a CUDA graph -------------------------------------------


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _sgns_inputs(cuda, neg_pool, dtype, n=3000, dim=64, wb=64, t=21, steps=20):
    """A step's config, ``steps`` chunks of walks, the vocabulary and a
    table factory (fresh tables from one seed on each call)."""
    from pecanpy_tpu_torch.models import sgns

    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    config = sgns.SGNSConfig(dim=dim, window=5, negative=5, neg_pool=neg_pool, seed=3)
    walks = torch.randint(0, n, (steps * wb, t), generator=gen, device=cuda,
                          dtype=torch.int32)
    eff = torch.randint(1, t + 1, (steps * wb,), generator=gen, device=cuda,
                        dtype=torch.int32)
    counts = sgns._count_tokens(walks, eff, n)
    keep = sgns._keep_probs(counts, config.sample)
    neg_table = torch.from_numpy(
        sgns.build_negative_table(counts.cpu().numpy(), size=1 << 16, seed=3)).to(cuda)

    def tables():
        return sgns.init_tables(3, n, dim, dtype, cuda)

    return config, walks, eff, keep, neg_table, tables


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("neg_pool", [4096, 0])  # the pool branch, direct negatives
def test_graphed_step_body_byte_equal_to_eager(cuda, neg_pool, dtype):
    """20 chunk-steps through the graph and through the eager seam: both
    tables byte-equal after every step, one capture and 19 replays, and no
    host-device sync in a replayed chunk-step (its draws included)."""
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.utils import trace

    wb, t, n = 64, 21, 3000
    config, walks, eff, keep, neg_table, tables = _sgns_inputs(cuda, neg_pool, dtype)
    assert sgns._uses_pool(config, wb * t) == bool(neg_pool)
    graphed, eager = sgns.make_step_body(n, config), sgns.make_step_body(n, config, _graph=False)
    t_graph, t_eager = tables(), tables()
    with trace.job("pecanpy.test_graph"):
        for i in range(20):
            sl, lr = slice(i * wb, (i + 1) * wb), 0.025 * (1 - i / 40)
            if i >= 2:  # after the eager warm-up and the capture
                torch.cuda.set_sync_debug_mode("error")
            try:
                draws = sgns.draw_step(3, i, wb, t, config, neg_table.shape[0], cuda)
                graphed(*t_graph, walks[sl], eff[sl], keep, neg_table, lr, draws)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eager(*t_eager, walks[sl], eff[sl], keep, neg_table, lr, draws)
            for got, want in zip(t_graph, t_eager):
                assert torch.equal(_bits(got), _bits(want)), i
    rec = trace.last_job("pecanpy.test_graph")
    assert rec.counter("sgns.graph_captures") == 1
    assert rec.counter("sgns.graph_replays") == 19
    assert not torch.equal(_bits(t_graph[1]), _bits(tables()[1]))  # the steps moved W_out


def test_graphed_step_body_recaptures_on_new_tables(cuda):
    """Tables at another address change the key: an eager step, then a new
    capture, each step byte-equal to the eager seam on the same tables."""
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.utils import trace

    wb, t, n = 64, 21, 3000
    config, walks, eff, keep, neg_table, tables = _sgns_inputs(
        cuda, 4096, torch.bfloat16, steps=6)
    graphed, eager = sgns.make_step_body(n, config), sgns.make_step_body(n, config, _graph=False)
    first = (tables(), tables())
    second = tuple((a.clone(), b.clone()) for a, b in first)
    with trace.job("pecanpy.test_graph"):
        for i in range(6):
            t_graph, t_eager = first if i < 3 else second
            sl = slice(i * wb, (i + 1) * wb)
            draws = sgns.draw_step(3, i, wb, t, config, neg_table.shape[0], cuda)
            graphed(*t_graph, walks[sl], eff[sl], keep, neg_table, 0.025, draws)
            eager(*t_eager, walks[sl], eff[sl], keep, neg_table, 0.025, draws)
            for got, want in zip(t_graph, t_eager):
                assert torch.equal(_bits(got), _bits(want)), i
    rec = trace.last_job("pecanpy.test_graph")
    # steps 0-2 on the first tables: eager, capture, replay; 3-5 on the
    # second: eager, capture, replay
    assert rec.counter("sgns.graph_captures") == 2
    assert rec.counter("sgns.graph_replays") == 4


def test_graphed_embed_frees_its_graph(cuda, monkeypatch):
    """Two ``embed`` calls back to back leave the card's allocated memory
    within a few MB of one call's (the graph and its pool go with the
    step), each call captures once, and the embeddings are byte-equal to
    the eager seam's."""
    import gc

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.utils import trace

    n = 2000
    adj = (np.random.default_rng(9).random((n, n)) < 0.004).astype(float)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    adj[np.arange(n), (np.arange(n) + 1) % n] = adj[(np.arange(n) + 1) % n, np.arange(n)] = 1.0
    g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(n)], p=0.5, q=2.0,
                                   random_state=5, device=cuda)
    # 128 walks of 81 tokens a chunk-step: 10,368 x 5 negatives take the pool
    kw = dict(dim=64, num_walks=2, walk_length=80, window_size=5, batch_walks=128,
              table_dtype="bfloat16")
    allocated = []
    for _ in range(2):
        out = g.embed(**kw)
        assert trace.last_job("pecanpy.embed").counter("sgns.graph_captures") == 1
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(cuda))
    assert abs(allocated[1] - allocated[0]) <= 4 << 20, allocated
    make = sgns.make_step_body
    monkeypatch.setattr(sgns, "make_step_body",
                        lambda *a, **k: make(*a, **k, _graph=False))
    eager = g.embed(**kw)
    assert trace.last_job("pecanpy.embed").counter("sgns.graph_replays") == 0
    assert eager.tobytes() == out.tobytes()


def _graphed_hub_walks(cuda, dg, chunks, p, q):
    """``generate_walks_queued`` with node2vec+ (the plain trial block's
    route) over ``chunks`` in one job: each call's (walks, eff, rounds),
    and the job's record."""
    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.utils import trace

    start = torch.arange(dg.num_nodes, dtype=torch.int32, device=cuda).repeat(4)
    with trace.job("pecanpy.test_hub_graph"):
        out = [engine.generate_walks_queued(
            dg, start, engine.TrialDrawStream(5, c, 2, cuda), 12, p, q, True, lanes=256,
            return_rounds=True) for c in chunks]
    torch.cuda.synchronize()
    return out, trace.last_job("pecanpy.test_hub_graph")


@pytest.mark.parametrize("directed", [False, True])  # directed: wp from membership
@pytest.mark.parametrize("p,q", [(0.5, 0.5), (0.25, 2.0)])  # atom off / on
def test_graphed_hub_rounds_bit_equal_to_eager(cuda, monkeypatch, p, q, directed):
    """node2vec+'s queued rounds replayed from one captured CUDA graph: two
    chunks, then the first again (a second call under the key), one
    capture, every block but the first a replay, and walks, effective
    lengths and rounds bit-equal to the eager engine's."""
    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.ops.layout import device_csr_from_dense

    adj, cap = _hub_graph(13, directed=directed, float_weights=True)
    dg = device_csr_from_dense(adj, degree_cap=cap, with_cdf=True, device=cuda)
    assert dg.has_hubs and dg.symmetric != directed
    got, rec = _graphed_hub_walks(cuda, dg, (0, 1, 0), p, q)
    rounds = sum(r for _, _, r in got)
    assert rec.counter("walk.hub_rounds") == rounds > 3 * 16
    assert rec.counter("walk.hub_graph_captures") == 1
    assert rec.counter("walk.hub_graph_rounds") == rounds - 16  # the first block eager
    monkeypatch.setattr(engine, "_replays_rounds", lambda *args: False)
    want, rec = _graphed_hub_walks(cuda, dg, (0, 1, 0), p, q)
    assert rec.counter("walk.hub_graph_captures") == rec.counter("walk.hub_graph_rounds") == 0
    for (w_g, e_g, r_g), (w_w, e_w, r_w) in zip(got, want):
        assert torch.equal(w_g, w_w) and torch.equal(e_g, e_w) and r_g == r_w
    assert torch.equal(got[2][0], got[0][0]) and not torch.equal(got[1][0], got[0][0])
    w, e = got[1][0].cpu().numpy(), got[1][1].cpu().numpy()
    for row, m in zip(w, e):
        assert all(adj[a, b] != 0 for a, b in zip(row[: m - 1], row[1:m]))


def test_graphed_hub_walks_free_their_graph(cuda, monkeypatch):
    """node2vec+ ``simulate_walks_device`` on a hub graph: the first call
    captures, the second only replays (every round), both bit-equal to
    the eager engine; dropping the mode frees the graph's captured rounds
    and its memory pool."""
    import gc

    from pecanpy_tpu_torch import pecanpy
    from pecanpy_tpu_torch.models import engine
    from pecanpy_tpu_torch.utils import trace

    adj, cap = _hub_graph(17, n=400, float_weights=True)
    gc.collect()
    torch.cuda.synchronize()
    base_mem, base_entries = torch.cuda.memory_allocated(cuda), len(engine._ROUND_GRAPHS)
    g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(adj.shape[0])], p=0.5,
                                   q=0.5, extend=True, random_state=3, degree_cap=cap,
                                   device=cuda)
    assert g.get_device_graph().has_hubs
    out = []
    for i in range(2):
        out.append(g.simulate_walks_device(8, 20))
        rec = trace.last_job("pecanpy.walks")
        assert rec.counter("walk.hub_graph_captures") == 1 - i
        if i:
            assert rec.counter("walk.hub_graph_rounds") == rec.counter("walk.hub_rounds") > 0
    assert len(engine._ROUND_GRAPHS) == base_entries + 1
    monkeypatch.setattr(engine, "_replays_rounds", lambda *args: False)
    eager = g.simulate_walks_device(8, 20)
    for got in out:
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    del g, out, eager, rec
    gc.collect()
    torch.cuda.synchronize()
    assert len(engine._ROUND_GRAPHS) == base_entries
    assert torch.cuda.memory_allocated(cuda) - base_mem <= 1 << 20
