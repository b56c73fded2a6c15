"""SGNS trainer of the PyTorch port against the JAX package.

The port takes each step's random numbers as one ``StepDraws``; these
tests build it from the JAX key tree (``split(key, 4)`` ->
``key_sub, key_win, key_neg, key_rnd``) so both trainers see identical
draws. Tolerances: one step allclose rtol=1e-5, atol=1e-6 (f32 matmuls
and reductions in another order); a few chunk-steps rtol=1e-4, atol=1e-6
(the same differences, compounded over steps).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecanpy_tpu.models import sgns as jsgns
from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.models import sgns

T = torch.from_numpy


def jax_draws(key, wb, t, config, table_size) -> sgns.StepDraws:
    """The draws ``pecanpy_tpu``'s ``make_step_body`` takes from ``key``."""
    key_sub, key_win, key_neg, key_rnd = jax.random.split(key, 4)
    rng_seed = int(jax.random.randint(key_rnd, (), 0, 2**30 - 1, dtype=jnp.int32))
    u = jax.random.uniform(key_sub, (wb, t))
    eff_win = config.window - jax.random.randint(key_win, (wb, t), 0, config.window)
    if sgns._uses_pool(config, wb * t):
        k_pool, k_off = jax.random.split(key_neg)
        slots = jax.random.randint(k_pool, (config.neg_pool,), 0, table_size)
        off = int(jax.random.randint(k_off, (), 0, config.neg_pool))
    else:
        slots = jax.random.randint(key_neg, (wb, t, config.negative), 0, table_size)
        off = 0
    return sgns.StepDraws(
        T(np.array(u)), T(np.array(eff_win)).long(), T(np.array(slots)).long(),
        off, rng_seed,
    )


def test_counts_and_keep_probs_bitwise(rng):
    n = 30
    walks = rng.integers(0, n, (12, 9)).astype(np.int32)
    eff = rng.integers(1, 10, 12).astype(np.int32)
    want = np.asarray(jsgns._count_tokens(jnp.asarray(walks), jnp.asarray(eff), n))
    got = sgns._count_tokens(T(walks), T(eff), n).numpy()
    np.testing.assert_array_equal(got, want)
    for sample in (1e-3, 0.05, 0.0):
        np.testing.assert_array_equal(
            sgns._keep_probs(T(got), sample).numpy(),
            np.asarray(jsgns._keep_probs(jnp.asarray(want), sample)),
        )


@pytest.mark.parametrize("neg_pool", [64, 0])
def test_step_matches_jax(rng, neg_pool):
    """One ``make_step_body`` step, pool on (64 slots < BT * K) and off."""
    n, dim, wb, t = 40, 16, 6, 12
    config = sgns.SGNSConfig(dim=dim, window=3, negative=4, neg_pool=neg_pool)
    jconfig = jsgns.SGNSConfig(dim=dim, window=3, negative=4, neg_pool=neg_pool)
    assert sgns._uses_pool(config, wb * t) == bool(neg_pool)
    walks = rng.integers(0, n, (wb, t)).astype(np.int32)
    eff = np.array([12, 12, 7, 1, 12, 4], dtype=np.int32)
    w_in = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    keep = rng.uniform(0.5, 1.0, n).astype(np.float32)
    neg_table = rng.integers(0, n, 512).astype(np.int32)
    key = jax.random.PRNGKey(9)

    want = jax.jit(jsgns.make_step_body(n, jconfig))(
        jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(walks),
        jnp.asarray(eff), jnp.asarray(keep), jnp.asarray(neg_table),
        jnp.float32(0.02), key,
    )
    t_in, t_out = sgns.tables_from_numpy(w_in, w_out, "cpu")
    sgns.make_step_body(n, config)(
        t_in, t_out, T(walks), T(eff), T(keep), T(neg_table), 0.02,
        jax_draws(key, wb, t, config, neg_table.size),
    )
    for got, ref in zip((t_in, t_out), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert not np.allclose(t_out.numpy(), w_out)  # the step did move W_out


@pytest.mark.parametrize("off", [0, 1, 63])  # 0, 1 and M - 1
def test_roll_left_is_torch_roll(off):
    pool = torch.from_numpy(np.random.default_rng(off).integers(0, 1000, 64))
    assert torch.equal(sgns._roll_left(pool, torch.tensor(off)), torch.roll(pool, -off))


@pytest.mark.parametrize("k,bt,m", [(5, 100035, 32768), (5, 32768, 32768), (5, 40, 32),
                                    (3, 7, 8), (6, 5, 4)])
def test_cached_stripe_bases_are_stripe_bases(k, bt, m):
    got = sgns._stripe_bases_tensor(k, bt, m, torch.device("cpu"))
    assert got.dtype == torch.int64
    assert got.tolist() == sgns._stripe_bases(k, bt, m)
    assert sgns._stripe_bases_tensor(k, bt, m, torch.device("cpu")) is got


@pytest.mark.parametrize("groups", [False, True])
def test_cpu_and_group_steps_stay_eager(rng, monkeypatch, groups):
    """A step on CPU tables, or with collective groups, never goes through
    a graph (both graph counters stay 0); one-rank groups whose
    collectives return their input give the single-device step's bits."""
    from pecanpy_tpu_torch.utils import trace

    made = []

    class NoGraph:
        def __init__(self, body):
            made.append(body)

        def __call__(self, *args):
            raise AssertionError("the step went through a graph")

    n, dim, wb, t = 40, 16, 6, 12
    config = sgns.SGNSConfig(dim=dim, window=3, negative=4, neg_pool=64, seed=1)
    walks = T(rng.integers(0, n, (wb, t)).astype(np.int32))
    eff = T(np.array([12, 12, 7, 1, 12, 4], dtype=np.int32))
    keep = T(rng.uniform(0.5, 1.0, n).astype(np.float32))
    neg_table = T(rng.integers(0, n, 512).astype(np.int32))
    init = [(rng.standard_normal((n, dim)) * 0.1).astype(np.float32) for _ in range(2)]
    draws = sgns.draw_step(1, 0, wb, t, config, 512, "cpu")
    assert sgns._uses_pool(config, wb * t)

    def run(**kw):
        tables = sgns.tables_from_numpy(*init, "cpu")
        with trace.job("pecanpy.test_step"):
            sgns.make_step_body(n, config, **kw)(*tables, walks, eff, keep, neg_table,
                                                 0.02, draws)
        rec = trace.last_job("pecanpy.test_step")
        assert rec.counter("sgns.graph_captures") == rec.counter("sgns.graph_replays") == 0
        return tables

    want = run()
    monkeypatch.setattr(sgns, "_GraphedBody", NoGraph)
    if groups:
        solo = types.SimpleNamespace(all_reduce=lambda x, op="sum": x, all_gather=lambda x: x)
        got = run(model_group=solo, data_group=solo)
        assert made == []  # no graph is even built with a group
    else:
        got = run()
        assert len(made) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _two_cliques(k=8):
    n = 2 * k
    adj = np.zeros((n, n))
    adj[:k, :k] = 1.0
    adj[k:, k:] = 1.0
    np.fill_diagonal(adj, 0.0)
    adj[0, k] = adj[k, 0] = 1.0
    return adj


@pytest.mark.parametrize("neg_pool", [256, 0])
def test_train_matches_jax(rng, neg_pool):
    """A few chunk-steps over two epochs, with the JAX init and the JAX
    ``fold_in(k_train, g)`` draws injected."""
    n, dim = 30, 8
    walks = rng.integers(0, n, (40, 10)).astype(np.int32)
    eff = rng.integers(2, 11, 40).astype(np.int32)
    kw = dict(dim=dim, window=3, epochs=2, batch_walks=16, seed=3, neg_pool=neg_pool)
    config, jconfig = sgns.SGNSConfig(**kw), jsgns.SGNSConfig(**kw)
    want = np.asarray(jsgns.train(jnp.asarray(walks), jnp.asarray(eff), n, jconfig, max_steps=5))

    k_init, k_train = jax.random.split(jax.random.PRNGKey(3))
    bound = 0.5 / dim
    w_in = jax.random.uniform(k_init, (n, dim), minval=-bound, maxval=bound)
    tables = sgns.tables_from_numpy(np.asarray(w_in), np.zeros((n, dim)), "cpu")
    table_size = 1 << 22

    def draws(g, wb, t):
        return jax_draws(jax.random.fold_in(k_train, g), wb, t, config, table_size)

    got = sgns.train(T(walks), T(eff), n, config, max_steps=5,
                     _tables=tables, _draws=draws)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert not np.allclose(got, np.asarray(w_in))


def test_streaming_embed_matches_materialized():
    """Two-pass streaming embed equals the stored-walk path exactly."""
    adj = _two_cliques()
    ids = [str(i) for i in range(adj.shape[0])]
    embs = [
        pecanpy.SparseOTF.from_mat(adj, ids, random_state=0, device="cpu").embed(
            dim=16, num_walks=4, walk_length=10, window_size=3, epochs=2,
            streaming=streaming,
        )
        for streaming in (True, False)
    ]
    np.testing.assert_array_equal(embs[0], embs[1])


def test_streaming_walk_cache_equivalence():
    """Replaying the device walk cache equals regenerating the walks."""
    adj = _two_cliques()
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=4, device="cpu")
    config = sgns.SGNSConfig(dim=8, window=3, epochs=2, seed=0)
    outs = [
        sgns.train_streaming(
            lambda _pass: g._walk_chunks(4, 8), g.num_nodes, config,
            cache_walks_bytes=cb,
        )
        for cb in (0, None)
    ]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_max_steps_prefix_of_full_run():
    """Draws are a function of (seed, global step): a run cut after k
    steps equals the first k steps of a longer run under one lr plan."""
    rng = np.random.default_rng(1)
    walks = T(rng.integers(0, 20, (30, 8)).astype(np.int32))
    eff = T(np.full(30, 8, dtype=np.int32))
    config = sgns.SGNSConfig(dim=8, window=2, epochs=1, batch_walks=10, seed=0)
    a = sgns.train(walks, eff, 20, config, max_steps=2)
    b = sgns.train(walks, eff, 20, config, max_steps=2)
    c = sgns.train(walks, eff, 20, config, max_steps=3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_resolve_table_dtype():
    cfg = sgns.SGNSConfig(dim=128, table_dtype="auto")
    small_n = sgns.AUTO_F32_TABLE_ELEMS // 128
    assert sgns.resolve_table_dtype(cfg, small_n, "cuda") == torch.float32
    assert sgns.resolve_table_dtype(cfg, small_n + 1, "cuda") == torch.bfloat16
    assert sgns.resolve_table_dtype(cfg, small_n + 1, "cpu") == torch.float32
    explicit = dataclasses.replace(cfg, table_dtype="float32")
    assert sgns.resolve_table_dtype(explicit, 10**9, "cuda") == torch.float32
    with pytest.warns(UserWarning, match="round-to-nearest"):
        sgns.resolve_table_dtype(dataclasses.replace(cfg, table_dtype="bfloat16"), 10, "cpu")


def test_shared_host_helpers_equal_jax():
    counts = np.random.default_rng(2).integers(0, 50, 300).astype(np.float32)
    np.testing.assert_array_equal(
        sgns.build_negative_table(counts, size=4096, seed=5),
        jsgns.build_negative_table(counts, size=4096, seed=5),
    )
    for k, bt, m in [(5, 32768, 32768), (5, 40, 32), (3, 7, 8)]:
        assert sgns._stripe_bases(k, bt, m) == jsgns._stripe_bases(k, bt, m)
    cfg = sgns.SGNSConfig()
    assert sgns.resolve_batch_walks(cfg, 10**6, 81) == jsgns.resolve_batch_walks(
        jsgns.SGNSConfig(), 10**6, 81
    ) == 1235
