"""The port's fused trial block on the CPU against the JAX Pallas kernels.

``trialkernel.trial_block_fused`` takes node ids and, on CPU tensors, its
plain version on the gathered rows; it must equal the JAX package's
``trial_block_fused`` (the Pallas kernels ``_k1_propose`` / ``_k2_accept``
in interpret mode, on the carried rows) bit for bit on an integer-weight
hub graph, fed the same key tree's draws, with and without the ``cdf``
channel, as ``tests/test_trialkernel.py`` holds the JAX kernels against
``rejection._trial_block``. The plain halves that ``chip_smoke.py`` and
the ``gpu`` tests hold each CUDA kernel against must compose to the same
block, also on rows of the degrees the kernels' reads turn on (no JAX
kernel runs there). The launcher's grid arithmetic is checked here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecanpy_tpu.ops import trialkernel as jtrialkernel
from pecanpy_tpu_torch.ops import layout, rejection, trialkernel
from pecanpy_tpu_torch.ops.rejection import RoundDraws
from test_torch_hubs import _bits, _t, atom_state, edge_lanes, int_hub_graph, jax_trial_draws, pair
from test_torch_kernels import DEGREE_CAP, EDGE_DEGREES, degree_graph, degree_lanes


def _lanes(rng, use_cdf, b=96):
    adj = int_hub_graph(rng)
    port, ref = pair(adj, with_cdf=use_cdf)
    cur, prev = edge_lanes(rng, adj, b)
    rows = [ref.gather_rows(jnp.asarray(v)) for v in (cur, prev)]
    rows_p = [port.gather_rows(torch.from_numpy(v)) for v in (cur, prev)]
    return port, ref, cur, prev, rows, rows_p


@pytest.mark.parametrize(
    "trials,use_atom,use_cdf",
    [(1, True, True), (2, True, False), (2, False, True), (1, False, False)],
)
def test_fused_block_equals_jax_pallas(rng, trials, use_atom, use_cdf):
    port, ref, cur, prev, rows, rows_p = _lanes(rng, use_cdf)
    p, q = (0.5, 2.0) if use_atom else (2.0, 0.5)
    alpha_np = max(1.0, 1.0 / q)
    theta = wp = None
    if use_atom:
        theta, wp = atom_state(ref, jnp.asarray(prev), rows[0], p, q)
    key = jax.random.PRNGKey(11)
    want = jtrialkernel.trial_block_fused(
        ref, key, jnp.asarray(prev), rows[0], rows[1], p, q, alpha_np, trials,
        theta, wp, use_cdf=use_cdf, interpret=True,
    )
    got = trialkernel.trial_block_fused(
        port, RoundDraws.stack(jax_trial_draws(key, trials, ref.rows_degree(rows[0]))),
        torch.from_numpy(prev), torch.from_numpy(cur), p, q, alpha_np,
        None if theta is None else _t(theta), None if wp is None else _t(wp),
        use_cdf=use_cdf,
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("use_cdf", [False, True])
def test_plain_halves_compose_to_the_block(rng, use_cdf):
    port, ref, cur, prev, rows, rows_p = _lanes(rng, use_cdf, b=128)
    p, q = 0.5, 2.0
    theta, wp = (_t(a) for a in atom_state(ref, jnp.asarray(prev), rows[0], p, q))
    draws = RoundDraws.stack(
        jax_trial_draws(jax.random.PRNGKey(4), 3, ref.rows_degree(rows[0]))
    )
    prev_t, cur_t = torch.from_numpy(prev), torch.from_numpy(cur)
    force_ok = torch.from_numpy(rng.random(prev.size) < 0.25)
    x, wx = trialkernel.trial_propose_plain(port, draws, prev_t, cur_t, theta, wp, use_cdf)
    assert x.shape == (3, prev.size) and x.dtype == torch.int32
    got = trialkernel.trial_accept_plain(
        port, draws, x, wx, prev_t, p, q, 1.0, True, force_ok
    )
    want = rejection._trial_block(
        port, draws.trials(), prev_t, rows_p[0], rows_p[1], p, q, False, 1.0, theta, wp,
        use_cdf=use_cdf, force_ok=force_ok,
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[1][force_ok].all())


def _numpy_draws(gen, trials, deg):
    """A round's draws made with numpy: kk uniform in [0, max(deg, 1))."""
    b = deg.shape[0]
    kk = np.minimum(
        (gen.random((trials, b)) * np.maximum(deg, 1)).astype(np.int32), np.maximum(deg, 1) - 1
    )
    u = gen.random((trials, 4, b), dtype=np.float32)
    return RoundDraws(torch.from_numpy(kk.astype(np.int32)), torch.from_numpy(u))


@pytest.mark.parametrize("trials", [1, 8])
@pytest.mark.parametrize("use_cdf", [True, False])
def test_id_block_equals_trial_block_on_gathered_rows(trials, use_cdf):
    """The id interface (the block, and its two plain halves composed) is
    ``rejection._trial_block`` on the gathered rows, bit for bit, on rows
    of degree 0, 1, 31, 32, 33 and dpad, hubs, and node N - 1, as cur and
    as prev, with the return-edge atom and ``force_ok``."""
    adj = degree_graph(trials, float_weights=True)
    dg = layout.device_csr_from_dense(adj, degree_cap=DEGREE_CAP, with_cdf=use_cdf, device="cpu")
    assert dg.dpad == DEGREE_CAP and dg.has_hubs
    cur_np, prev_np = degree_lanes(adj, 301, seed=trials)
    cur, prev = torch.from_numpy(cur_np), torch.from_numpy(prev_np)
    cur_rows, prev_rows = dg.gather_rows(cur), dg.gather_rows(prev)
    deg = dg.rows_degree(cur_rows)
    assert set(EDGE_DEGREES) <= set(deg.tolist())
    assert bool(dg.rows_is_hub(cur_rows).any()) and bool(dg.rows_is_hub(prev_rows).any())
    gen = np.random.default_rng(trials)
    draws = _numpy_draws(gen, trials, deg.numpy())
    p, q = 0.5, 2.0
    alpha_np = max(1.0, 1.0 / q)
    _, wp = rejection.membership(dg, prev, cur_rows)
    theta = torch.from_numpy(gen.random(cur.numel(), dtype=np.float32) * 0.5)
    force_ok = torch.from_numpy(gen.random(cur.numel()) < 0.25)
    want = rejection._trial_block(
        dg, draws.trials(), prev, cur_rows, prev_rows, p, q, False, alpha_np, theta, wp,
        use_cdf=use_cdf, force_ok=force_ok,
    )
    got = trialkernel.trial_block_fused(
        dg, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf=use_cdf, force_ok=force_ok
    )
    x, wx = trialkernel.trial_propose_plain(dg, draws, prev, cur, theta, wp, use_cdf)
    halves = trialkernel.trial_accept_plain(
        dg, draws, x, wx, prev, p, q, alpha_np, True, force_ok
    )
    for a, b, c in zip(got, halves, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    # the dead node's proposals without the atom pick its padding slot
    picked = (cur == 0)[None] & ~(draws.u[:, 2] < theta)
    assert bool(picked.any()) and bool((x[picked] == dg.num_nodes).all())


@pytest.mark.parametrize("lanes_per_block", [8, 32, 64])
def test_trial_grid(lanes_per_block):
    """The launcher's grid: enough blocks of ``lanes_per_block`` lanes
    for B lanes, and a refusal past the int32 grid limit."""
    lim = trialkernel.INT32_MAX
    assert trialkernel.trial_grid(0, lanes_per_block) == 0
    assert trialkernel.trial_grid(1, lanes_per_block) == 1
    assert trialkernel.trial_grid(3, lanes_per_block) == 1
    assert trialkernel.trial_grid(32768, lanes_per_block) == 32768 // lanes_per_block
    assert trialkernel.trial_grid(32768 + 1, lanes_per_block) == 32768 // lanes_per_block + 1
    assert trialkernel.trial_grid(lim * lanes_per_block, lanes_per_block) == lim
    with pytest.raises(ValueError, match="grid limit"):
        trialkernel.trial_grid(lim * lanes_per_block + 1, lanes_per_block)
