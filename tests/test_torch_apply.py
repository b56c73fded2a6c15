"""The sparse-row update applier of the PyTorch port (``ops/apply.py``).

On the CPU the public entry points take the scatter path, the one the
JAX package takes without Pallas, and they are held against it and a
numpy loop (rtol=2e-5, atol=1e-6: f32 sums in another order). The
stream prep + ``apply_sorted_stream`` route, which a CUDA table takes,
runs here through the kernel's plain version and must equal the scatter
path at the same tolerance. The CUDA kernel itself is tested on the card
(``tests/test_torch_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecanpy_tpu.ops import apply as japply
from pecanpy_tpu_torch.ops import apply as apply_lib
from pecanpy_tpu_torch.ops.apply import apply_mean_updates, apply_mean_updates_two

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
