"""The port's fused trial block on the CPU against the JAX Pallas kernels.

``trialkernel.trial_block_fused`` takes its plain version on CPU tensors;
it must equal the JAX package's ``trial_block_fused`` (the Pallas kernels
``_k1_propose`` / ``_k2_accept`` in interpret mode) bit for bit on an
integer-weight hub graph, fed the same key tree's draws, with and without
the ``cdf`` channel, as ``tests/test_trialkernel.py`` holds the JAX
kernels against ``rejection._trial_block``. The plain halves that
``chip_smoke.py`` holds each CUDA kernel against must compose to the
same block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecanpy_tpu.ops import trialkernel as jtrialkernel
from pecanpy_tpu_torch.ops import rejection, trialkernel
from pecanpy_tpu_torch.ops.rejection import RoundDraws
from test_torch_hubs import _bits, _t, atom_state, edge_lanes, int_hub_graph, jax_trial_draws, pair


def _lanes(rng, use_cdf, b=96):
    adj = int_hub_graph(rng)
    port, ref = pair(adj, with_cdf=use_cdf)
    cur, prev = edge_lanes(rng, adj, b)
    rows = [ref.gather_rows(jnp.asarray(v)) for v in (cur, prev)]
    rows_p = [port.gather_rows(torch.from_numpy(v)) for v in (cur, prev)]
    return port, ref, prev, rows, rows_p


@pytest.mark.parametrize(
    "trials,use_atom,use_cdf",
    [(1, True, True), (2, True, False), (2, False, True), (1, False, False)],
)
def test_fused_block_equals_jax_pallas(rng, trials, use_atom, use_cdf):
    port, ref, prev, rows, rows_p = _lanes(rng, use_cdf)
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
        torch.from_numpy(prev), rows_p[0], rows_p[1], p, q, alpha_np,
        None if theta is None else _t(theta), None if wp is None else _t(wp),
        use_cdf=use_cdf,
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("use_cdf", [False, True])
def test_plain_halves_compose_to_the_block(rng, use_cdf):
    port, ref, prev, rows, rows_p = _lanes(rng, use_cdf, b=128)
    p, q = 0.5, 2.0
    theta, wp = (_t(a) for a in atom_state(ref, jnp.asarray(prev), rows[0], p, q))
    draws = RoundDraws.stack(
        jax_trial_draws(jax.random.PRNGKey(4), 3, ref.rows_degree(rows[0]))
    )
    prev_t = torch.from_numpy(prev)
    force_ok = torch.from_numpy(rng.random(prev.size) < 0.25)
    x, wx = trialkernel.trial_propose_plain(port, draws, prev_t, rows_p[0], theta, wp, use_cdf)
    assert x.shape == (3, prev.size) and x.dtype == torch.int32
    got = trialkernel.trial_accept_plain(
        port, draws, x, wx, prev_t, rows_p[1], p, q, 1.0, True, force_ok
    )
    want = rejection._trial_block(
        port, draws.trials(), prev_t, rows_p[0], rows_p[1], p, q, False, 1.0, theta, wp,
        use_cdf=use_cdf, force_ok=force_ok,
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[1][force_ok].all())
