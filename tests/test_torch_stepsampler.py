"""The per-step hub sampler of the PyTorch port against the JAX package.

``_compact_indices`` must return the JAX package's indices, and
``second_order_sample`` its samples bit for bit on integer-weight graphs
when fed the JAX key tree's draws through the ``draws(phase, deg,
trials)`` seam (phase t reads ``fold_in(key, t)``): with and without the
return-edge atom, directed and undirected, hub-partitioned and without
hubs. Whole walks under ``PECANPY_TPU_AMORTIZED=0`` (the scan engine with
the sampler) equal the JAX walks bit for bit, the fused uniforms from
``jax_walk_uniforms`` and each step's sampler draws from
``split(step_key)[1]``. With the port's own draws the walks follow the
exact second-order law (4.5 binomial sigma per frequency, as
``tests/test_hubs.py``), and ``embed`` runs without a ``cdf`` channel.

The JAX sampler compiles its sweep loop for each case, so the cases stay
few and small (at most 64 lanes, walks of 4 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from pecanpy_tpu import pecanpy as jax_pecanpy
from pecanpy_tpu.ops import layout as jlayout
from pecanpy_tpu.ops import rejection as jrejection
from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import layout, rejection
from pecanpy_tpu_torch.ops.rejection import RoundDraws, TrialDraws
from pecanpy_tpu_torch.utils import trace
from test_torch_hubs import (
    _t,
    edge_lanes,
    hub_cap,
    int_hub_graph,
    jax_propose_draws,
    jax_trial_draws,
    pair,
)
from test_torch_hubwalk import CAP, _law_check
from test_torch_walk import jax_walk_uniforms


def _ids(n):
    return [str(i) for i in range(n)]


def jax_phase_draws(key):
    """The sampler's draws of ``jrejection.second_order_sample(key)``:
    phase t's trial block reads ``fold_in(key, t)``."""

    def draws(phase, deg, trials):
        return RoundDraws.stack(
            jax_trial_draws(jax.random.fold_in(key, phase), trials, deg.numpy())
        )

    return draws


@pytest.mark.parametrize("b,s", [(64, 8), (300, 64), (1024, 128), (1000, 1000)])
def test_compact_indices_equal_jax(rng, b, s):
    """The same indices as the JAX blocked search, invalid slots included
    (``tests/test_hubs.py``'s cases)."""
    pending = rng.random(b) < 0.3
    want_idx, want_valid = jrejection._compact_indices(jnp.asarray(pending), s)
    idx, valid = rejection._compact_indices(torch.from_numpy(pending), s)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def test_compact_indices_empty_equal_jax():
    pending = np.zeros(100, dtype=bool)
    want_idx, want_valid = jrejection._compact_indices(jnp.asarray(pending), 16)
    idx, valid = rejection._compact_indices(torch.from_numpy(pending), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert not valid.any() and not np.asarray(want_valid).any()


@pytest.mark.parametrize(
    "directed,p,q,hubs",
    [
        (False, 0.5, 2.0, True),   # return-edge atom on
        (True, 2.0, 0.5, True),    # no atom
        (False, 0.5, 2.0, False),  # one "row" group: no hubs anywhere
    ],
)
def test_second_order_sample_bitwise(rng, directed, p, q, hubs):
    adj = int_hub_graph(rng, n=24, directed=directed)
    if hubs:
        port, ref = pair(adj)
    else:
        ref = jlayout.device_csr_from_dense(adj)
        port = layout.device_csr_from_dense(adj, device="cpu")
        assert not port.has_hubs
    cur, prev = edge_lanes(rng, adj, 64)
    jc, jp = jnp.asarray(cur), jnp.asarray(prev)
    jcr, jpr = ref.gather_rows(jc), ref.gather_rows(jp)
    if hubs:
        active = np.array(ref.rows_is_hub(jcr) | ref.rows_is_hub(jpr))
        assert 0 < active.sum() < active.size
    else:
        active = rng.random(cur.size) < 0.6
    key = jax.random.PRNGKey(11)
    want = jax.jit(
        lambda k, a: jrejection.second_order_sample(
            ref, k, jc, jp, jcr, jpr, p, q, False, a
        )
    )(key, jnp.asarray(active))

    tc, tp = torch.from_numpy(cur), torch.from_numpy(prev)
    with trace.job("pecanpy.test.sample"):
        got = rejection.second_order_sample(
            port, jax_phase_draws(key), tc, tp, port.gather_rows(tc), port.gather_rows(tp),
            p, q, False, torch.from_numpy(active),
        )
    sweeps = trace.last_job("pecanpy.test.sample").counter("walk.sweeps")
    assert 0 < sweeps < rejection.SWEEP_CAP
    np.testing.assert_array_equal(got.numpy()[active], np.asarray(want)[active])
    for c, x in zip(cur[active], got.numpy()[active]):
        assert adj[c, x] != 0, f"non-edge {c}->{x}"


def _jax_step_draws(key, walk_length):
    """The per-step sampler draws of ``pecanpy_tpu``'s ``generate_walks``
    under ``PECANPY_TPU_AMORTIZED=0``: the first step's alias draw from
    ``split(key)[0]`` (``propose``), step s's phases from
    ``split(step_key)[1]`` of ``split(split(key)[1], L - 1)[s - 2]``."""
    key_first, key_rest = jax.random.split(key)
    step_keys = jax.random.split(key_rest, walk_length - 1)

    def first(phase, deg, trials):
        assert phase == engine.FIRST and trials == 1
        kk, u_self, _ = jax_propose_draws(key_first, jnp.asarray(deg.numpy()))
        zero = torch.zeros(deg.shape[0])
        return RoundDraws.stack([TrialDraws(_t(kk), _t(u_self), zero, zero, zero)])

    def per_step(s):
        if s == 1:
            return first
        return jax_phase_draws(jax.random.split(step_keys[s - 2])[1])

    return per_step


@pytest.mark.parametrize("directed,p,q", [(False, 0.5, 2.0), (True, 2.0, 0.5)])
def test_walks_bitwise_with_jax_draws(rng, monkeypatch, directed, p, q):
    """Whole ``AMORTIZED=0`` walks: the scan engine with the sampler on a
    hub graph equals the JAX walk function bit for bit."""
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", "0")
    adj = int_hub_graph(rng, n=20, directed=directed)
    n, walk_length, cap = adj.shape[0], 4, hub_cap(adj)
    kw = dict(p=p, q=q, random_state=0, degree_cap=cap)
    jg = jax_pecanpy.SparseOTF.from_mat(adj, _ids(n), **kw)
    ref = jg.get_device_graph()
    start = np.tile(np.arange(n, dtype=np.int32), 3)
    key = jax.random.PRNGKey(5)
    want_w, want_e = jg._get_walk_fn(walk_length)(ref, (), jnp.asarray(start), key)

    g = pecanpy.SparseOTF.from_mat(adj, _ids(n), device="cpu", **kw)
    dg = g.get_device_graph()
    assert dg.has_hubs and "cdf" not in dg.channels
    first_fn, step_fn = g.make_step_fns()
    walks, eff = engine.generate_walks(
        dg,
        lambda uu, cur, rows, d: first_fn(dg, uu, cur, rows, d),
        lambda uu, cur, prev, cr, pr, d: step_fn(dg, uu, cur, prev, cr, pr, d),
        torch.from_numpy(start),
        torch.from_numpy(jax_walk_uniforms(key, walk_length, start.size)),
        walk_length,
        _jax_step_draws(key, walk_length),
    )
    np.testing.assert_array_equal(walks.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(eff.numpy(), np.asarray(want_e))


def test_second_order_law_own_draws(rng, monkeypatch):
    """The port's own draws under ``AMORTIZED=0`` hold the exact law
    (``tests/test_hubs.py:test_hub_second_order_distribution_per_step_sampler``)."""
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", "0")
    p, q = 0.5, 2.0
    adj = oracle.random_graph(rng, 8, mean_degree=5.0, weighted=True)
    g = pecanpy.SparseOTF.from_mat(
        adj, _ids(8), p=p, q=q, random_state=7, degree_cap=CAP, device="cpu"
    )
    assert g.get_device_graph().has_hubs
    walks, eff = g.simulate_walks_device(700, 4)
    _law_check(adj, walks, eff, p, q)


def test_walks_reproduce_per_chunk(rng, monkeypatch):
    """A chunk is a pure function of (seed, chunk index): two instances,
    and two passes of one instance, give the same walks over several
    chunks."""
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", "0")
    adj = oracle.random_graph(rng, 12, mean_degree=8.0, weighted=True)
    kw = dict(p=0.5, q=2.0, random_state=3, degree_cap=CAP, walker_batch=10, device="cpu")
    g1 = pecanpy.SparseOTF.from_mat(adj, _ids(12), **kw)
    g2 = pecanpy.SparseOTF.from_mat(adj, _ids(12), **kw)
    assert g1._walk_queue_factor() == 1
    w1, e1 = g1.simulate_walks_device(3, 6)
    w2, e2 = g2.simulate_walks_device(3, 6)
    w3, _ = g1.simulate_walks_device(3, 6)
    assert torch.equal(w1, w2) and torch.equal(e1, e2) and torch.equal(w1, w3)


def test_embed_on_hub_graph_builds_no_cdf(rng, monkeypatch):
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", "0")
    adj = oracle.random_graph(rng, 30, mean_degree=10.0, weighted=True)
    g = pecanpy.SparseOTF.from_mat(
        adj, _ids(30), p=0.5, q=2.0, random_state=0, degree_cap=CAP, device="cpu"
    )
    dg = g.get_device_graph()
    assert dg.has_hubs and dg.channels == ("nbr", "wgt")
    with pytest.warns(UserWarning, match="epochs=1"):
        emb = g.embed(dim=8, num_walks=2, walk_length=5, window_size=3)
    assert emb.shape == (30, 8) and np.isfinite(emb).all()
