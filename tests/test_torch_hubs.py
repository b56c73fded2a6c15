"""Hub layout and rejection sampler of the PyTorch port against the JAX package.

Every comparison is bitwise: the hub layout (fused rows with their marker
slots, the ``cdf`` channel, the packed alias and hash tables) and every
sampler function, fed the JAX key tree's own draws on integer-weight
graphs (exact prefix sums). node2vec+ biases hold at rtol 1e-6, because
``row_thresholds`` reduces in another order.

The JAX package builds its hub tables natively when it can; the native
alias construction breaks ties differently from the Python builder
(``pecanpy_tpu/ops/hubs.py:176-179``), so the port's ``edge_pack`` is held
against the JAX Python builder, and the samplers run on the JAX layout
carried across with ``from_numpy``.
"""
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from pecanpy_tpu.ops import hubs as jhubs
from pecanpy_tpu.ops import layout as jlayout
from pecanpy_tpu.ops import rejection as jrejection
from pecanpy_tpu_torch.ops import layout, rejection
from pecanpy_tpu_torch.ops.rejection import TrialDraws

def hub_cap(adj) -> int:
    """A degree cap that makes about half of the nodes hubs."""
    return int(np.median((adj > 0).sum(1)))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def int_hub_graph(rng, n=24, directed=False):
    """Graph with integer weights 1..3 (exact f32 prefix sums); no node
    without out-edges."""
    adj = (rng.random((n, n)) < 0.35).astype(np.float64)
    if not directed:
        adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    w = rng.integers(1, 4, (n, n)).astype(np.float64)
    w = w if directed else np.triu(w) + np.triu(w, 1).T
    adj = adj * w
    for i in range(n):
        if adj[i].sum() == 0:
            adj[i, (i + 1) % n] = 1.0
            if not directed:
                adj[(i + 1) % n, i] = 1.0
    return adj


def with_float_weights(rng, adj, directed=False):
    """The same edges with non-integer weights (symmetric unless directed)."""
    adj = adj + (adj > 0) * rng.random(adj.shape)
    return adj if directed else np.triu(adj) + np.triu(adj, 1).T


def pair(adj, **kw):
    """(port DeviceCSR on the CPU, JAX DeviceCSR) sharing the JAX tables,
    with about half of the nodes hubs."""
    ref = jlayout.device_csr_from_dense(adj, degree_cap=hub_cap(adj), **kw)
    assert ref.has_hubs
    return layout.from_numpy(jax.tree.map(np.asarray, ref)), ref


def edge_lanes(rng, adj, b):
    """b random (cur, prev) pairs with prev a neighbor of cur."""
    cur = rng.integers(0, adj.shape[0], b)
    prev = np.array([rng.choice(np.nonzero(adj[c])[0]) for c in cur])
    return cur.astype(np.int32), prev.astype(np.int32)


# -- the JAX key tree's draws, as the port's TrialDraws -----------------------


def jax_propose_draws(key, deg):
    """(kk, u_self, u_small) that ``jrejection.propose(key)`` draws."""
    b = deg.shape[0]
    k_hub, k_small = jax.random.split(key)
    k_slot, k_self = jax.random.split(k_hub)
    kk = jax.random.randint(k_slot, (b,), 0, jnp.maximum(deg, 1))
    return (
        kk.astype(jnp.int32),
        jax.random.uniform(k_self, (b,)),
        jax.random.uniform(k_small, (b,), dtype=jnp.float32),
    )


def jax_single_trial_draws(kt, deg) -> TrialDraws:
    """The draws of ``jrejection._single_trial(kt)``."""
    b = deg.shape[0]
    k_prop, k_acc, k_atom = jax.random.split(kt, 3)
    kk, u_self, u_small = jax_propose_draws(k_prop, deg)
    u_atom = jax.random.uniform(k_atom, (b,))
    u_acc = jax.random.uniform(k_acc, (b,))
    return TrialDraws(*(_t(a) for a in (kk, u_self, u_small, u_atom, u_acc)))


def jax_trial_draws(key, trials: int, deg) -> List[TrialDraws]:
    """The draws of ``jrejection._trial_block(key)``, trial by trial."""
    deg = jnp.asarray(np.asarray(deg))
    return [
        jax_single_trial_draws(jax.random.fold_in(key, t), deg)
        for t in range(trials)
    ]


def atom_state(ref, prev, cur_rows, p, q):
    """(theta, wp) of the return-edge atom, computed by the JAX package."""
    alpha_np = max(1.0, 1.0 / q)
    excess = 1.0 / p - alpha_np
    _, wp = jrejection.membership(ref, prev, cur_rows)
    wsum = jnp.where(
        ref.rows_is_hub(cur_rows), ref.rows_hub_wsum(cur_rows),
        jnp.sum(ref.rows_wgt(cur_rows), axis=-1),
    )
    theta = wp * excess / (wp * excess + alpha_np * jnp.maximum(wsum, 1e-30))
    return theta, wp


# -- layout --------------------------------------------------------------------


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("with_thr,with_cdf", [(False, False), (True, True)])
def test_hub_layout_bitwise(rng, directed, with_thr, with_cdf):
    """Fused rows with hub markers, the cdf channel and the hash buckets
    equal the JAX build bit for bit."""
    adj = with_float_weights(rng, int_hub_graph(rng, directed=directed), directed)
    kw = dict(gamma=0.5, with_thresholds=with_thr, with_cdf=with_cdf,
              degree_cap=hub_cap(adj))
    port = layout.device_csr_from_dense(adj, device="cpu", **kw)
    ref = jax.tree.map(np.asarray, jlayout.device_csr_from_dense(adj, **kw))
    assert port.has_hubs and ref.has_hubs
    assert port.channels == tuple(ref.channels)
    assert (port.dpad, port.max_degree, port.symmetric, port.hub_frac) == (
        ref.dpad, ref.max_degree, ref.symmetric, ref.hub_frac
    )
    for name in ("fused", "threshold", "hbuckets"):
        np.testing.assert_array_equal(
            _bits(getattr(port, name).numpy()), _bits(getattr(ref, name)), err_msg=name
        )
    for name in ("deg", "indptr"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), getattr(ref, name))
    assert port.symmetric == (not directed)


def test_edge_pack_equals_python_builder(rng):
    adj = with_float_weights(rng, int_hub_graph(rng))
    port = layout.device_csr_from_dense(adj, degree_cap=hub_cap(adj), device="cpu")
    rows, cols = np.nonzero(adj)
    deg = np.bincount(rows, minlength=adj.shape[0])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    hub_ids = np.nonzero(deg > hub_cap(adj))[0]
    pack, _ = jhubs.build_edge_pack(indptr, cols, adj[rows, cols].astype(np.float32), hub_ids)
    np.testing.assert_array_equal(
        _bits(port.edge_pack.numpy()), _bits(jlayout._pack_super(pack))
    )


def test_from_numpy_carries_hub_layout(rng):
    adj = int_hub_graph(rng)
    port, ref = pair(adj, with_cdf=True)
    ref = jax.tree.map(np.asarray, ref)
    for name in ("fused", "edge_pack", "hbuckets", "threshold"):
        np.testing.assert_array_equal(_bits(getattr(port, name).numpy()), _bits(getattr(ref, name)))
    assert port.has_hubs and port.hub_frac == ref.hub_frac
    assert port.channels == ("nbr", "wgt", "cdf")


def test_hub_accessors_bitwise(rng):
    adj = int_hub_graph(rng)
    port, ref = pair(adj)
    n = adj.shape[0]
    idx = np.arange(n, dtype=np.int32)
    rows_j = ref.gather_rows(jnp.asarray(idx))
    rows_p = port.gather_rows(torch.from_numpy(idx))
    for name in ("rows_is_hub", "rows_degree", "rows_edge_base",
                 "rows_hub_threshold", "rows_hub_wsum"):
        np.testing.assert_array_equal(
            getattr(port, name)(rows_p).numpy(), np.asarray(getattr(ref, name)(rows_j)),
            err_msg=name,
        )
    np.testing.assert_array_equal(port.rows_degree(rows_p).numpy(), (adj > 0).sum(1))
    # every slot of the table, plus out-of-range slots (clipped like JAX)
    n_slots = ref.edge_pack.shape[0] * layout.EP_SUPER
    slots = np.arange(-9, n_slots + 17, dtype=np.int32)
    np.testing.assert_array_equal(
        _bits(port.fetch_edge_slots(torch.from_numpy(slots)).numpy()),
        _bits(ref.fetch_edge_slots(jnp.asarray(slots))),
    )
    buckets = np.arange(-5, ref.hbuckets.shape[0] * layout.HB_SUPER + 7, dtype=np.int32)
    keys_p, vals_p = port.fetch_bucket(torch.from_numpy(buckets))
    keys_j, vals_j = ref.fetch_bucket(jnp.asarray(buckets))
    np.testing.assert_array_equal(keys_p.numpy(), np.asarray(keys_j))
    np.testing.assert_array_equal(_bits(vals_p.numpy()), _bits(vals_j))


# -- samplers ------------------------------------------------------------------


def test_membership_bitwise_and_exact(rng):
    """Every (prev, x) pair, hub and capped prev rows, all three modes."""
    adj = int_hub_graph(rng)
    adj[adj > 0] += 0.25  # exact in f32
    port, ref = pair(adj)
    n = adj.shape[0]
    prev = np.repeat(np.arange(n, dtype=np.int32), n + 1)
    x = np.tile(np.arange(n + 1, dtype=np.int32), n)  # incl. the sentinel
    rows_p = port.gather_rows(torch.from_numpy(prev))
    rows_j = ref.gather_rows(jnp.asarray(prev))
    for mode in ("auto", "row", "hub"):
        f_p, w_p = rejection.membership(port, torch.from_numpy(x), rows_p, mode=mode)
        f_j, w_j = jrejection.membership(ref, jnp.asarray(x), rows_j, mode=mode)
        np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_j), err_msg=mode)
        np.testing.assert_array_equal(_bits(w_p.numpy()), _bits(w_j), err_msg=mode)
    found, w = rejection.membership(port, torch.from_numpy(x), rows_p)
    real = x < n
    want = adj[prev[real], x[real]]
    np.testing.assert_array_equal(found.numpy()[real], want != 0)
    np.testing.assert_array_equal(w.numpy()[real], want.astype(np.float32))


@pytest.mark.parametrize("use_cdf", [False, True])
def test_propose_bitwise(rng, use_cdf):
    adj = int_hub_graph(rng)
    port, ref = pair(adj, with_cdf=use_cdf)
    cur = rng.integers(0, adj.shape[0], 256).astype(np.int32)
    rows_j = ref.gather_rows(jnp.asarray(cur))
    rows_p = port.gather_rows(torch.from_numpy(cur))
    key = jax.random.PRNGKey(3)
    x_j, w_j = jrejection.propose(ref, key, rows_j, use_cdf=use_cdf)
    kk, u_self, u_small = jax_propose_draws(key, ref.rows_degree(rows_j))
    x_p, w_p = rejection.propose(port, _t(u_small), rows_p, use_cdf, _t(kk), _t(u_self))
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(_bits(w_p.numpy()), _bits(w_j))
    assert (adj[cur, x_p.numpy()] != 0).all()
    is_hub = port.rows_is_hub(rows_p)
    assert 0 < int(is_hub.sum()) < cur.size  # both branches ran
    # alias_propose alone, on the hub lanes
    k_hub = jax.random.split(key)[0]
    xa_j, wa_j = jrejection.alias_propose(ref, k_hub, rows_j)
    xa_p, wa_p = rejection.alias_propose(port, _t(kk), _t(u_self), rows_p)
    hub = is_hub.numpy()
    np.testing.assert_array_equal(xa_p.numpy()[hub], np.asarray(xa_j)[hub])
    np.testing.assert_array_equal(_bits(wa_p.numpy()[hub]), _bits(np.asarray(wa_j)[hub]))


TRIAL_CASES = [
    # (p, q, trials, atom expected, force_ok)
    (0.5, 2.0, 1, True, False),
    (0.5, 2.0, 2, True, True),
    (2.0, 0.5, 2, False, False),
    (0.5, 0.3, 2, False, True),  # 1 / (1 / 0.3) is inexact: division matters
    (0.1, 0.3, 1, True, False),
]


@pytest.mark.parametrize("p,q,trials,atom,force", TRIAL_CASES)
def test_trial_block_bitwise(rng, p, q, trials, atom, force):
    adj = int_hub_graph(rng)
    port, ref = pair(adj, with_cdf=True)
    cur, prev = edge_lanes(rng, adj, 192)
    rows = [ref.gather_rows(jnp.asarray(v)) for v in (cur, prev)]
    rows_p = [port.gather_rows(torch.from_numpy(v)) for v in (cur, prev)]
    alpha_np = max(1.0, 1.0 / q)
    assert atom == (1.0 / p - alpha_np > 0)
    theta = wp = None
    if atom:
        theta, wp = atom_state(ref, jnp.asarray(prev), rows[0], p, q)
    force_ok = rng.random(cur.size) < 0.3 if force else None
    key = jax.random.PRNGKey(7)
    for use_cdf in (False, True):
        want = jrejection._trial_block(
            ref, key, jnp.asarray(prev), rows[0], rows[1], p, q, False, alpha_np,
            trials, theta, wp, use_cdf=use_cdf,
            force_ok=None if force_ok is None else jnp.asarray(force_ok),
        )
        got = rejection._trial_block(
            port, jax_trial_draws(key, trials, ref.rows_degree(rows[0])),
            torch.from_numpy(prev), rows_p[0], rows_p[1], p, q, False, alpha_np,
            None if theta is None else _t(theta), None if wp is None else _t(wp),
            use_cdf=use_cdf,
            force_ok=None if force_ok is None else torch.from_numpy(force_ok),
        )
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    assert 0 < int(got[1].sum()) < cur.size or force


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (2.0, 0.3)])
def test_single_trial_node2vec_plus_close(rng, p, q):
    """node2vec+ (extend=True): identical proposals and accept bits, and the
    bias factors at rtol 1e-6 (``row_thresholds`` reduces in another order)."""
    adj = int_hub_graph(rng)
    port, ref = pair(adj, gamma=0.5, with_thresholds=True)
    cur, prev = edge_lanes(rng, adj, 192)
    rows = [ref.gather_rows(jnp.asarray(v)) for v in (cur, prev)]
    rows_p = [port.gather_rows(torch.from_numpy(v)) for v in (cur, prev)]
    alpha_np = max(1.0, 1.0 / q)
    key = jax.random.PRNGKey(9)
    x_j, ok_j, w_j = jrejection._single_trial(
        ref, key, jnp.asarray(prev), rows[0], rows[1], p, q, True, alpha_np,
        None, None, "auto",
    )
    d = jax_single_trial_draws(key, ref.rows_degree(rows[0]))
    x_p, ok_p, w_p = rejection._single_trial(
        port, d, torch.from_numpy(prev), rows_p[0], rows_p[1], p, q, True,
        alpha_np, None, None,
    )
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(_bits(w_p.numpy()), _bits(w_j))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    alpha_j = jrejection._bias(ref, x_j, w_j, jnp.asarray(prev), rows[0], rows[1], p, q, True)
    alpha_p = rejection._bias(port, x_p, w_p, torch.from_numpy(prev), rows_p[0], rows_p[1], p, q, True)
    np.testing.assert_allclose(alpha_p.numpy(), np.asarray(alpha_j), rtol=1e-6, atol=0)


def test_first_order_law_float_weights(rng):
    """propose on float weights: hub and capped rows draw w(cur, .)."""
    adj = oracle.random_graph(rng, 10, mean_degree=6.0, weighted=True)
    port = layout.device_csr_from_dense(adj, degree_cap=hub_cap(adj), device="cpu")
    gen = torch.Generator().manual_seed(0)
    reps = 4000
    for u in range(adj.shape[0]):
        if adj[u].sum() == 0:
            continue
        rows = port.gather_rows(torch.full((reps,), u))
        deg = port.rows_degree(rows)
        uu = torch.rand((3, reps), generator=gen)
        x, w = rejection.propose(
            port, uu[0], rows, False, rejection.slot_offsets(uu[1], deg), uu[2]
        )
        x = x.numpy()
        nbrs = np.nonzero(adj[u])[0]
        freq = np.array([(x == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(freq, oracle.first_order_probs(adj, u), atol=0.05)
        np.testing.assert_array_equal(w.numpy(), adj[u, x].astype(np.float32))
