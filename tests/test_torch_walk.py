"""Transition weights, samplers and walks of the PyTorch port.

Exact comparisons feed the port the JAX key tree's own uniforms. Float
prefix sums may differ by an ulp between XLA's and torch's cumsum, so
walks are compared bitwise only on integer-weight graphs (every weight,
bias product and prefix sum is then exact); on a float-weight graph the
port's own walks are tested for their law against ``tests/oracle.py``.
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
from pecanpy_tpu.ops import sampling as jsampling
from pecanpy_tpu.ops import transition as jtransition
from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import layout, rejection, sampling, transition


def _ids(n):
    return [str(i) for i in range(n)]


def _pair(adj, **kw):
    """(port DeviceCSR on the CPU, JAX DeviceCSR) of one dense graph."""
    ref = jlayout.device_csr_from_dense(adj, **kw)
    return layout.from_numpy(jax.tree.map(np.asarray, ref)), ref


def _batch(rng, adj, b):
    """b random (cur, prev) pairs with prev a neighbor of cur."""
    n = adj.shape[0]
    cur = rng.integers(0, n, b)
    prev = np.array([rng.choice(np.nonzero(adj[c])[0]) for c in cur])
    return cur.astype(np.int32), prev.astype(np.int32)


def _int_graph(rng, n=24, mean_degree=5.0, directed=False):
    adj = oracle.random_graph(rng, n, mean_degree=mean_degree, directed=directed)
    adj = np.ceil(adj)  # integer weights 1..3: exact prefix sums
    if not directed:
        # no isolated nodes: every start walks
        for i in np.nonzero(adj.sum(1) == 0)[0]:
            j = (i + 1) % n
            adj[i, j] = adj[j, i] = 1.0
    return adj


def test_node2vec_weights_bitwise(rng):
    adj = oracle.random_graph(rng, 30, mean_degree=6.0)
    dg, ref = _pair(adj)
    cur, prev = _batch(rng, adj, 64)
    for p, q in [(0.5, 2.0), (1.0, 1.0), (2.0, 0.5), (0.3, 3.0)]:
        want = jtransition.node2vec_weights(ref, jnp.asarray(cur), jnp.asarray(prev), p, q)
        got = transition.node2vec_weights_rows(
            dg, dg.gather_rows(torch.from_numpy(cur)),
            dg.gather_rows(torch.from_numpy(prev)), torch.from_numpy(prev), p, q,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_node2vec_plus_weights_close(rng):
    """rtol=1e-6: ``row_thresholds`` reduces in another order."""
    adj = oracle.random_graph(rng, 30, mean_degree=6.0)
    dg, ref = _pair(adj, gamma=0.5, with_thresholds=True)
    cur, prev = _batch(rng, adj, 64)
    for p, q in [(0.5, 2.0), (2.0, 0.5)]:
        want = jtransition.node2vec_plus_weights(
            ref, jnp.asarray(cur), jnp.asarray(prev), p, q
        )
        got = transition.node2vec_plus_weights_rows(
            dg, dg.gather_rows(torch.from_numpy(cur)),
            dg.gather_rows(torch.from_numpy(prev)), torch.from_numpy(prev), p, q,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_samplers_same_choices(rng):
    """Same uniforms, bitwise-equal choices (JAX draws u from the key)."""
    b, d = 256, 24
    weights = rng.integers(0, 4, (b, d)).astype(np.float32)
    weights[:, 0] += 1.0  # no all-zero rows
    key = jax.random.PRNGKey(11)
    u = jax.random.uniform(key, (b, 1), dtype=jnp.float32)
    want = jsampling.categorical_rows(key, jnp.asarray(weights))
    got = sampling.categorical_rows(torch.from_numpy(np.array(u)), torch.from_numpy(weights))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cdf = np.cumsum(weights, axis=1) / np.cumsum(weights, axis=1)[:, -1:]
    want = jsampling.sample_from_cdf(key, jnp.asarray(cdf))
    got = sampling.sample_from_cdf(torch.from_numpy(np.array(u)), torch.from_numpy(cdf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = rng.integers(0, 1 << 30, (b, d)).astype(np.int32)
    np.testing.assert_array_equal(
        sampling.pick_int_columns(torch.from_numpy(vals), got).numpy(),
        np.asarray(jsampling.pick_int_columns(jnp.asarray(vals), jnp.asarray(got.numpy()))),
    )


def test_propose_same_draws(rng):
    """``propose`` draws its non-hub uniform from ``split(key)[1]``."""
    adj = _int_graph(rng)
    dg, ref = _pair(adj)
    cur = rng.integers(0, adj.shape[0], 128).astype(np.int32)
    key = jax.random.PRNGKey(3)
    x_j, w_j = jrejection.propose(ref, key, ref.gather_rows(jnp.asarray(cur)))
    u = jax.random.uniform(jax.random.split(key)[1], (cur.size,))
    x, w = rejection.propose(
        dg, torch.from_numpy(np.array(u))[:, None], dg.gather_rows(torch.from_numpy(cur))
    )
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))


def jax_walk_uniforms(key, walk_length, b) -> np.ndarray:
    """The [L, B] uniforms ``pecanpy_tpu``'s ``generate_walks`` draws from
    ``key`` for the OTF modes (first step: ``propose``; later steps:
    ``categorical_rows`` on ``split(step_key)[0]``)."""
    key_first, key_rest = jax.random.split(key)
    rows = [jax.random.uniform(jax.random.split(key_first)[1], (b,))]
    for sk in jax.random.split(key_rest, walk_length - 1):
        rows.append(jax.random.uniform(jax.random.split(sk)[0], (b, 1))[:, 0])
    return np.stack([np.asarray(r) for r in rows])


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (1.0, 1.0), (2.0, 0.5), (0.5, 0.5)])
@pytest.mark.parametrize("directed", [False, True])
def test_walks_bitwise_integer_weights(p, q, directed, rng):
    adj = _int_graph(rng, directed=directed)
    n, walk_length = adj.shape[0], 12
    jg = jax_pecanpy.SparseOTF.from_mat(adj, _ids(n), p=p, q=q, random_state=0)
    ref = jg.get_device_graph()
    start = np.tile(np.arange(n, dtype=np.int32), 3)
    key = jax.random.PRNGKey(5)
    want_w, want_e = jg._get_walk_fn(walk_length)(ref, (), jnp.asarray(start), key)

    g = pecanpy.SparseOTF.from_mat(adj, _ids(n), p=p, q=q, device="cpu")
    dg = g.get_device_graph()
    first_fn, step_fn = g.make_step_fns()
    u = torch.from_numpy(jax_walk_uniforms(key, walk_length, start.size))
    walks, eff = engine.generate_walks(
        dg,
        lambda uu, cur, rows: first_fn(dg, uu, cur, rows),
        lambda uu, cur, prev, cr, pr: step_fn(dg, uu, cur, prev, cr, pr),
        torch.from_numpy(start), u, walk_length,
    )
    np.testing.assert_array_equal(walks.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(eff.numpy(), np.asarray(want_e))


def test_start_nodes_equal_jax(rng):
    adj = oracle.random_graph(rng, 9, mean_degree=3.0)
    g = pecanpy.SparseOTF.from_mat(adj, _ids(9), random_state=4, device="cpu")
    jg = jax_pecanpy.SparseOTF.from_mat(adj, _ids(9), random_state=4)
    np.testing.assert_array_equal(g._start_nodes(3), jg._start_nodes(3))


@pytest.mark.parametrize("mode", [pecanpy.SparseOTF, pecanpy.DenseOTF])
def test_walks_follow_edges_and_reproduce(mode, rng):
    adj = oracle.random_graph(rng, 12, mean_degree=4.0)
    g = mode.from_mat(adj, _ids(12), p=0.5, q=2.0, random_state=0, device="cpu")
    walks, eff = g.simulate_walks_device(2, 6)
    assert walks.shape == (24, 7) and walks.dtype == torch.int32
    for row, n in zip(walks.numpy(), eff.numpy()):
        for a, b in zip(row[: n - 1], row[1:n]):
            assert adj[a, b] != 0, f"non-edge {a}->{b}"
    g2 = mode.from_mat(adj, _ids(12), p=0.5, q=2.0, random_state=0, device="cpu")
    w2, e2 = g2.simulate_walks_device(2, 6)
    assert torch.equal(walks, w2) and torch.equal(eff, e2)


def test_early_termination_at_sink():
    adj = np.zeros((3, 3))
    adj[0, 1] = adj[1, 2] = 1.0  # directed path 0 -> 1 -> 2; 2 is a sink
    g = pecanpy.SparseOTF.from_mat(adj, _ids(3), random_state=0, device="cpu")
    walks, eff = g.simulate_walks_device(1, 5)
    by_start = {int(w[0]): (w, int(e)) for w, e in zip(walks.numpy(), eff.numpy())}
    assert by_start[2][1] == 1
    assert by_start[1][1] == 2
    assert by_start[0][1] == 3
    np.testing.assert_array_equal(by_start[0][0][:3], [0, 1, 2])


@pytest.mark.parametrize("p,q,extend", [(0.5, 2.0, False), (2.0, 0.5, True)])
def test_second_order_law_float_weights(p, q, extend, rng):
    """The port's own walks on a float-weight graph follow the oracle's
    second-order law (tolerance: 4.5 binomial sigma per frequency)."""
    adj = oracle.random_graph(rng, 8, mean_degree=3.5, weighted=True)
    g = pecanpy.SparseOTF.from_mat(
        adj, _ids(8), p=p, q=q, extend=extend, gamma=0.0, random_state=7,
        device="cpu",
    )
    walks, eff = g.simulate_walks_device(600, 4)
    counts = {}
    for row, m in zip(walks.numpy(), eff.numpy()):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        if extend:
            expected = oracle.node2vec_plus_probs(adj, cur, prev, p, q, 0.0)
        else:
            expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts)),
            err_msg=f"cur={cur} prev={prev} n={len(nxts)}",
        )
        checked += 1
    assert checked >= 3, "not enough high-count transitions to test"
