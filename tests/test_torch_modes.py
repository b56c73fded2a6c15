"""The remaining walk modes of the PyTorch port: FirstOrderUnweighted,
PreCompFirstOrder, PreComp and the experimental Node2vecPlusPlus.

Deterministic parts are held against the JAX package on the same arrays
(bitwise for integer outputs and integer-weight graphs, rtol=1e-6 where
float reductions may run in another order); walks are held bit for bit
against the JAX engine with its key tree's uniforms injected, or, where
the JAX draws are ``randint`` values the port draws otherwise, to their
law against ``tests/oracle.py`` (4.5 binomial sigma per frequency).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from pecanpy_tpu import pecanpy as jax_pecanpy
from pecanpy_tpu.experimental import Node2vecPlusPlus as JaxNode2vecPlusPlus
from pecanpy_tpu.ops import layout as jlayout
from pecanpy_tpu.ops import rejection as jrejection
from pecanpy_tpu.ops import transition as jtransition
from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.experimental import Node2vecPlusPlus
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import layout, rejection, transition

T = torch.from_numpy


def _ids(n):
    return [str(i) for i in range(n)]


def _carry(ref):
    """The port's DeviceCSR on the CPU from a JAX one."""
    return layout.from_numpy(jax.tree.map(np.asarray, ref))


def _int_graph(rng, n=24, mean_degree=5.0):
    adj = np.ceil(oracle.random_graph(rng, n, mean_degree=mean_degree))
    for i in np.nonzero(adj.sum(1) == 0)[0]:  # every start walks
        j = (i + 1) % n
        adj[i, j] = adj[j, i] = 1.0
    return adj


def _hub_graph(rng, n=60, cap=6):
    """Undirected graph whose two first nodes are hubs above ``cap``."""
    adj = _int_graph(rng, n, mean_degree=4.0)
    for hub in (0, 1):
        nbrs = rng.choice(np.arange(2, n), 20, replace=False)
        adj[hub, nbrs] = adj[nbrs, hub] = rng.integers(1, 4, 20)
    return adj, cap


def _batch(rng, adj, b):
    """b random (cur, prev) pairs with prev a neighbor of cur."""
    cur = rng.integers(0, adj.shape[0], b)
    prev = np.array([rng.choice(np.nonzero(adj[c])[0]) for c in cur])
    return cur.astype(np.int32), prev.astype(np.int32)


# -- ops: transition and proposal functions ----------------------------------


def test_row_functions_equal_jax(rng):
    adj = oracle.random_graph(rng, 30, mean_degree=6.0)
    ref = jlayout.device_csr_from_dense(adj, gamma=0.5, with_thresholds=True)
    dg = _carry(ref)
    cur, prev = _batch(rng, adj, 64)
    j_cur, j_prev = ref.gather_rows(jnp.asarray(cur)), ref.gather_rows(jnp.asarray(prev))
    cur_rows, prev_rows = dg.gather_rows(T(cur)), dg.gather_rows(T(prev))
    queries = np.stack([prev, cur, np.full(64, adj.shape[0]), np.zeros(64)], 1).astype(np.int32)
    np.testing.assert_array_equal(
        transition.row_searchsorted(dg.rows_nbr(cur_rows), T(queries)).numpy(),
        np.asarray(jtransition.row_searchsorted(ref.rows_nbr(j_cur), jnp.asarray(queries))),
    )
    np.testing.assert_array_equal(
        transition.row_degrees(dg, cur_rows).numpy(),
        np.asarray(jtransition.row_degrees(ref, j_cur)),
    )
    np.testing.assert_allclose(
        transition.first_order_weights_rows(dg, cur_rows).numpy(),
        np.asarray(jtransition.first_order_weights_rows(ref, j_cur)), rtol=1e-6, atol=0,
    )
    for p, q in [(0.5, 2.0), (2.0, 0.5), (1.0, 1.0)]:
        np.testing.assert_allclose(
            transition.node2vec_pp_weights_rows(dg, cur_rows, prev_rows, T(prev), p, q).numpy(),
            np.asarray(jtransition.node2vec_pp_weights_rows(
                ref, j_cur, j_prev, jnp.asarray(prev), p, q)),
            rtol=1e-6, atol=0,
        )


@pytest.mark.parametrize("hubs", [False, True])
def test_uniform_propose_equals_jax(hubs, rng):
    """Same slot offsets (JAX's ``randint`` values injected), same node."""
    if hubs:
        adj, cap = _hub_graph(rng)
    else:
        adj, cap = _int_graph(rng), None
    ref = jlayout.device_csr_from_dense(adj, degree_cap=cap)
    assert ref.has_hubs == hubs
    dg = _carry(ref)
    cur = np.concatenate([[0, 1], rng.integers(0, adj.shape[0], 254)]).astype(np.int32)
    j_rows = ref.gather_rows(jnp.asarray(cur))
    key = jax.random.PRNGKey(4)
    deg = ref.rows_degree(j_rows)
    kk = jax.random.randint(key, deg.shape, 0, jnp.maximum(deg, 1)).astype(jnp.int32)
    want = np.asarray(jrejection.uniform_propose(ref, key, j_rows))
    got = rejection.uniform_propose(dg, T(np.array(kk)), dg.gather_rows(T(cur))).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(adj[c, x] != 0 for c, x in zip(cur, got))


def test_precomp_first_order_propose_with_hubs_equals_jax(rng):
    """PreCompFirstOrder's move on a hub graph: the cdf channel for capped
    rows, the alias slots for hubs, with JAX's draws injected."""
    adj, cap = _hub_graph(rng)
    adj = adj * rng.uniform(0.5, 2.0, adj.shape)  # float weights
    adj = np.triu(adj) + np.triu(adj, 1).T
    ref = jlayout.device_csr_from_dense(adj, degree_cap=cap, with_cdf=True)
    dg = _carry(ref)
    cur = np.concatenate([[0, 1], rng.integers(0, adj.shape[0], 254)]).astype(np.int32)
    j_rows = ref.gather_rows(jnp.asarray(cur))
    key = jax.random.PRNGKey(9)
    x_j, _ = jrejection.propose(ref, key, j_rows, use_cdf=True)
    k_hub, k_small = jax.random.split(key)
    k_slot, k_acc = jax.random.split(k_hub)
    deg = ref.rows_degree(j_rows)
    u = np.array(jax.random.uniform(k_small, (cur.size,)))
    kk = np.array(jax.random.randint(k_slot, deg.shape, 0, jnp.maximum(deg, 1)))
    u_self = np.array(jax.random.uniform(k_acc, deg.shape))
    x, _ = rejection.propose(dg, T(u)[:, None], dg.gather_rows(T(cur)), True,
                             T(kk.astype(np.int32)), T(u_self))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j))


# -- PreComp's per-edge CDF table --------------------------------------------


@pytest.mark.parametrize("weights", ["integer", "float"])
@pytest.mark.parametrize("extend", [False, True])
def test_precomp_edge_cdf_equals_jax(weights, extend, rng):
    adj = _int_graph(rng, 30, 6.0)
    if weights == "float":
        adj = adj * rng.uniform(0.5, 2.0, adj.shape)
        adj = np.triu(adj) + np.triu(adj, 1).T
    kw = dict(p=0.5, q=2.0, extend=extend, gamma=0.5, random_state=0)
    jg = jax_pecanpy.PreComp.from_mat(adj, _ids(30), **kw)
    jg.preprocess_transition_probs()
    g = pecanpy.PreComp.from_mat(adj, _ids(30), device="cpu", **kw)
    g._device_graph = _carry(jg.get_device_graph())
    g.preprocess_transition_probs()
    want, got = np.asarray(jg.edge_cdf), g.edge_cdf.numpy()
    assert got.shape == want.shape == (int((adj != 0).sum()), got.shape[1])
    if weights == "integer" and not extend:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_precomp_chunked_build_bit_identical(rng, monkeypatch):
    adj = oracle.random_graph(rng, 60, mean_degree=12.0)
    g = pecanpy.PreComp.from_mat(adj, _ids(60), p=0.5, q=2.0, device="cpu")
    g.preprocess_transition_probs()
    one_shot = g.edge_cdf
    assert one_shot.shape[0] > 512, "need several 256-edge slices"
    monkeypatch.setenv("PECANPY_TPU_PRECOMP_BUILD_MB", "0")  # 256-edge slices
    g.preprocess_transition_probs()
    assert torch.equal(g.edge_cdf, one_shot)


def test_precomp_guard_and_uncapped_rows(rng):
    adj, _ = _hub_graph(rng)
    g = pecanpy.PreComp.from_mat(adj, _ids(adj.shape[0]), device="cpu", degree_cap=6)
    assert g.degree_cap is None and not g.get_device_graph().has_hubs
    dg = g.get_device_graph()
    # a graph of 2^26 edges: E * 64 reaches 2^31
    g._device_graph = dataclasses.replace(dg, indptr=torch.tensor([0, 2**26]))
    with pytest.raises(ValueError, match="2\\^31"):
        g.preprocess_transition_probs()


# -- walks -------------------------------------------------------------------


def _jax_uniforms(key, walk_length, b, split_first):
    """[L, B] uniforms the JAX scan engine draws from ``key``: the step's
    own key (PreComp's ``sample_from_cdf``) or its ``split(key)[1]``
    (``propose``)."""
    key_first, key_rest = jax.random.split(key)
    keys = [key_first, *jax.random.split(key_rest, walk_length - 1)]
    if split_first:
        keys = [jax.random.split(k)[1] for k in keys]
    return np.stack([np.asarray(jax.random.uniform(k, (b, 1)))[:, 0] for k in keys])


def _run_scan(g, u, start, walk_length):
    g._preprocess_transition_probs()
    dg = g.get_device_graph()
    first_fn, step_fn = g.make_step_fns()
    return engine.generate_walks(
        dg,
        lambda uu, cur, rows: first_fn(dg, uu, cur, rows),
        lambda uu, cur, prev, cr, pr: step_fn(dg, uu, cur, prev, cr, pr),
        torch.from_numpy(start), torch.from_numpy(u), walk_length,
    )


@pytest.mark.parametrize("mode", ["PreComp", "PreCompFirstOrder"])
@pytest.mark.parametrize("p,q", [(0.5, 2.0), (1.0, 1.0), (2.0, 0.5)])
def test_precomp_walks_bitwise_integer_weights(mode, p, q, rng):
    adj = _int_graph(rng)
    n, walk_length = adj.shape[0], 10
    jg = getattr(jax_pecanpy, mode).from_mat(adj, _ids(n), p=p, q=q, random_state=0)
    jg.preprocess_transition_probs()
    start = np.tile(np.arange(n, dtype=np.int32), 3)
    key = jax.random.PRNGKey(6)
    want_w, want_e = jg._get_walk_fn(walk_length)(
        jg.get_device_graph(), jg._walk_aux(), jnp.asarray(start), key)
    g = getattr(pecanpy, mode).from_mat(adj, _ids(n), p=p, q=q, device="cpu")
    u = _jax_uniforms(key, walk_length, start.size, split_first=mode != "PreComp")
    walks, eff = _run_scan(g, u, start, walk_length)
    np.testing.assert_array_equal(walks.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(eff.numpy(), np.asarray(want_e))


def test_precomp_wide_degree_fallback_bitwise(rng, monkeypatch):
    """Nodes wider than the table row take the on-the-fly law with the
    same uniform: walks still equal the JAX engine's."""
    adj, _ = _hub_graph(rng, n=40)  # two nodes of degree > 8
    monkeypatch.setattr(jax_pecanpy.PreComp, "PRECOMP_WIDTH", 8)
    jg = jax_pecanpy.PreComp.from_mat(adj, _ids(40), p=0.5, q=2.0, random_state=0)
    jg.preprocess_transition_probs()
    start = np.tile(np.arange(40, dtype=np.int32), 3)
    key = jax.random.PRNGKey(2)
    want_w, _ = jg._get_walk_fn(8)(jg.get_device_graph(), jg._walk_aux(), jnp.asarray(start), key)
    g = pecanpy.PreComp.from_mat(adj, _ids(40), p=0.5, q=2.0, device="cpu")
    g.PRECOMP_WIDTH = 8
    walks, _ = _run_scan(g, _jax_uniforms(key, 8, start.size, False), start, 8)
    np.testing.assert_array_equal(walks.numpy(), np.asarray(want_w))


def _transitions(walks, eff, order):
    """(context tuple) -> list of next nodes, over all walks."""
    counts = {}
    for row, m in zip(walks.numpy(), eff.numpy()):
        for j in range(order, m):
            counts.setdefault(tuple(row[j - order:j]), []).append(row[j])
    return counts


def _check_law(counts, adj, probs, min_count=300):
    checked = 0
    for ctx, nxts in counts.items():
        if len(nxts) < min_count:
            continue
        nbrs = np.nonzero(adj[ctx[-1]])[0]
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, probs(*ctx), atol=4.5 * np.sqrt(0.25 / len(nxts)), err_msg=str(ctx))
        checked += 1
    assert checked >= 3, "not enough high-count transitions to test"


def test_first_order_unweighted_law_with_hubs(rng):
    adj, cap = _hub_graph(rng)
    adj = (adj != 0).astype(float)
    g = pecanpy.FirstOrderUnweighted.from_mat(
        adj, _ids(adj.shape[0]), degree_cap=cap, random_state=3, device="cpu")
    assert g.get_device_graph().has_hubs and "cdf" not in g.get_device_graph().channels
    walks, eff = g.simulate_walks_device(150, 5)
    _check_law(_transitions(walks, eff, 1), adj,
               lambda cur: np.full(int((adj[cur] != 0).sum()), 1.0 / (adj[cur] != 0).sum()))


def test_precomp_first_order_law_with_hubs(rng):
    adj, cap = _hub_graph(rng)
    adj = adj * rng.uniform(0.5, 2.0, adj.shape)
    adj = np.triu(adj) + np.triu(adj, 1).T
    g = pecanpy.PreCompFirstOrder.from_mat(
        adj, _ids(adj.shape[0]), degree_cap=cap, random_state=3, device="cpu")
    assert g.get_device_graph().has_hubs and g._draw_width() == 3
    walks, eff = g.simulate_walks_device(150, 5)
    _check_law(_transitions(walks, eff, 1), adj, lambda cur: oracle.first_order_probs(adj, cur))


def test_precomp_second_order_law_float_weights(rng):
    adj = oracle.random_graph(rng, 8, mean_degree=3.5, weighted=True)
    g = pecanpy.PreComp.from_mat(adj, _ids(8), p=0.5, q=2.0, random_state=7, device="cpu")
    walks, eff = g.simulate_walks_device(600, 4)
    _check_law(_transitions(walks, eff, 2), adj,
               lambda prev, cur: oracle.node2vec_probs(adj, cur, prev, 0.5, 2.0), 400)


def test_node2vec_pp_step_equals_jax_and_law(rng):
    """One step with JAX's uniform injected picks JAX's node (unit weights:
    every bias is a power of two, so the prefix sums are exact); walks on a
    float-weight graph follow the oracle's node2vec++ law."""
    adj = (oracle.random_graph(rng, 30, mean_degree=6.0) != 0).astype(float)
    for i in np.nonzero(adj.sum(1) == 0)[0]:
        adj[i, (i + 1) % 30] = adj[(i + 1) % 30, i] = 1.0
    jg = JaxNode2vecPlusPlus.from_mat(adj, _ids(30), p=0.5, q=2.0)
    ref = jg.get_device_graph()
    _, j_step = jg.make_step_fns()
    g = Node2vecPlusPlus.from_mat(adj, _ids(30), p=0.5, q=2.0, device="cpu")
    dg = g.get_device_graph()
    _, step = g.make_step_fns()
    cur, prev = _batch(rng, adj, 256)
    key = jax.random.PRNGKey(1)
    want = j_step(ref, (), key, jnp.asarray(cur), jnp.asarray(prev),
                  ref.gather_rows(jnp.asarray(cur)), ref.gather_rows(jnp.asarray(prev)))
    u = T(np.array(jax.random.uniform(key, (256, 1))))
    got = step(dg, u, T(cur), T(prev), dg.gather_rows(T(cur)), dg.gather_rows(T(prev)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    adj = oracle.random_graph(rng, 8, mean_degree=3.5, weighted=True)
    g = Node2vecPlusPlus.from_mat(adj, _ids(8), p=0.5, q=2.0, gamma=0.0,
                                  random_state=5, device="cpu")
    walks, eff = g.simulate_walks_device(600, 4)
    _check_law(_transitions(walks, eff, 2), adj,
               lambda prev, cur: oracle.node2vec_pp_probs(adj, cur, prev, 0.5, 2.0, 0.0), 400)


# -- the walk route: which engine, queue factor, sampler and cdf channel ------

_OTF = ("SparseOTF", "DenseOTF")
_ROUTES = [(m, h, a) for m in _OTF + ("FirstOrderUnweighted", "PreCompFirstOrder")
           for h in (True, False) for a in (("1", "0") if m in _OTF else ("1",))]


@pytest.mark.parametrize("mode,hubs,amortized", _ROUTES)
def test_walk_route(mode, hubs, amortized, rng, monkeypatch):
    """The mode's spec and ``PECANPY_TPU_AMORTIZED`` alone route a walk: the
    OTF modes take the queued hub engine on a hub graph (8 x lanes walks a
    chunk, the cdf channel) or, under ``AMORTIZED=0``, the scan engine with
    the per-step sampler; every other case the plain scan engine, with the
    cdf channel only where PreCompFirstOrder's steps read it."""
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", amortized)
    ran = []
    for name in ("generate_walks", "generate_walks_queued", "generate_walks_amortized"):
        def spy(*args, _name=name, _fn=getattr(engine, name), **kwargs):
            ran.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(engine, name, spy)
    adj, cap = _hub_graph(rng, n=30)
    g = getattr(pecanpy, mode).from_mat(
        adj, _ids(30), p=0.5, q=2.0, random_state=0, device="cpu",
        degree_cap=cap if hubs else None,
    )
    dg = g.get_device_graph()
    assert dg.has_hubs == hubs
    walks, eff = g.simulate_walks_device(1, 4)
    assert walks.shape == (30, 5) and (eff == 5).all()
    hub_engine = hubs and mode in _OTF
    queued = hub_engine and amortized == "1"
    assert ran == ["generate_walks_queued" if queued else "generate_walks"]
    assert g._walk_queue_factor() == (engine.HUB_QUEUE_FACTOR if queued else 1)
    assert g._uses_step_sampler() == hub_engine
    assert ("cdf" in dg.channels) == (queued or mode == "PreCompFirstOrder")


# -- each mode through embed() ------------------------------------------------


@pytest.mark.parametrize("mode", ["FirstOrderUnweighted", "PreCompFirstOrder", "PreComp",
                                  "Node2vecPlusPlus"])
def test_mode_embed_cpu(mode, rng):
    weighted = mode != "FirstOrderUnweighted"
    adj = oracle.random_graph(rng, 20, mean_degree=5.0, weighted=weighted)
    cls = Node2vecPlusPlus if mode == "Node2vecPlusPlus" else getattr(pecanpy, mode)
    kw = dict(p=0.5, q=2.0) if mode in ("PreComp", "Node2vecPlusPlus") else {}
    g = cls.from_mat(adj, _ids(20), random_state=0, device="cpu", **kw)
    emb = g.embed(dim=12, num_walks=2, walk_length=6, window_size=3, epochs=2)
    assert emb.shape == (20, 12) and np.isfinite(emb).all() and emb.std() > 0
