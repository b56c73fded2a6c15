"""The CUDA applier kernel against its plain torch version, on the card.

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
about half of them. Rows no id names stay bit-equal.
"""
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
    # a whole stream of one id: one segment, one warp; 2^-10 payloads keep
    # every partial sum exact, so only the final subtraction rounds
    ids = torch.full((5000,), 7, dtype=torch.int32, device=cuda)
    upd = torch.full((5000, 8), 2.0**-10, device=cuda)
    apply_lib.apply_sorted_stream(table, ids, upd)
    assert torch.equal(table[7], keep[7] - 5000 * 2.0**-10)
    assert torch.equal(table[:7], keep[:7]) and torch.equal(table[8:], keep[8:])


@pytest.mark.parametrize("d", [8, 13])
@pytest.mark.parametrize("sign", ["positive", "mixed"])
def test_kernel_long_segment_accuracy(cuda, d, sign):
    """One warp sums a segment serially in f32, so the error grows with the
    segment's length n. Held to the serial-summation bound against a
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
