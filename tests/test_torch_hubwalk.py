"""The port's hub walkers against the JAX package, and their law.

Both engines (queued and per-batch amortized) must reproduce the JAX
engines' walks bit for bit on integer-weight hub graphs when fed the JAX
key tree's draws through the ``draws(round, deg)`` seam. On float weights
the port's own walks are tested for the exact second-order law against
``tests/oracle.py`` (tolerance: 4.5 binomial sigma per frequency), as
``tests/test_hubs.py`` tests the JAX walkers. The slice as a whole:
``embed`` on a block-model graph with hubs clears the micro-F1 gate, and
the CLI with a small ``--degree-cap`` is reproducible.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from pecanpy_tpu.models import engine as jengine
from pecanpy_tpu_torch import cli, pecanpy
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import trialkernel
from pecanpy_tpu_torch.ops.layout import device_csr_from_dense
from pecanpy_tpu_torch.ops.rejection import RoundDraws, TrialDraws
from test_downstream import micro_f1_nearest_centroid, sbm_graph
from test_torch_hubs import _t, int_hub_graph, jax_propose_draws, jax_trial_draws, pair

CAP = 6


def jax_queued_draws(key, trials=2):
    """The queued JAX engine's draws: round t uses ``fold_in(key, t)``."""

    def draws(t, deg):
        return RoundDraws.stack(
            jax_trial_draws(jax.random.fold_in(key, t), trials, deg.numpy())
        )

    return draws


def jax_amortized_draws(key, trials=2):
    """The amortized JAX engine's draws: the first-order proposal from
    ``split(key)[0]``, round t from ``fold_in(split(key)[1], t)``."""
    key_first, key_rounds = jax.random.split(key)

    def draws(t, deg):
        if t == engine.FIRST:
            kk, u_self, u_small = jax_propose_draws(key_first, jnp.asarray(deg.numpy()))
            zero = torch.zeros(deg.shape[0])
            return RoundDraws.stack(
                [TrialDraws(_t(kk), _t(u_self), _t(u_small), zero, zero)]
            )
        return RoundDraws.stack(
            jax_trial_draws(jax.random.fold_in(key_rounds, t), trials, deg.numpy())
        )

    return draws


@pytest.mark.parametrize(
    "queued,directed,p,q,use_cdf",
    [
        (True, False, 0.5, 2.0, True),
        (True, True, 0.5, 2.0, False),
        (False, False, 0.5, 2.0, False),
        (False, True, 2.0, 0.5, True),
    ],
)
def test_walks_bitwise_with_jax_draws(rng, queued, directed, p, q, use_cdf):
    adj = int_hub_graph(rng, n=20, directed=directed)
    port, ref = pair(adj, with_cdf=use_cdf)
    assert port.symmetric == (not directed)
    n, walk_length = adj.shape[0], 7
    start = np.tile(np.arange(n, dtype=np.int32), 3)
    key = jax.random.PRNGKey(5)
    # blocks of 2 rounds: the JAX engines compile their unrolled block,
    # which at the default 16 (queued) rounds takes half a minute here
    if queued:
        kw = dict(lanes=24, return_rounds=True)
        want = jengine.generate_walks_queued(
            ref, jnp.asarray(start), key, walk_length, p, q, False,
            unroll=1, flush_every=2, **kw,
        )
        got = engine.generate_walks_queued(
            port, torch.from_numpy(start), jax_queued_draws(key), walk_length,
            p, q, False, block_rounds=2, **kw,
        )
    else:
        kw = dict(unroll=2, return_rounds=True)
        want = jengine.generate_walks_amortized(
            ref, jnp.asarray(start), key, walk_length, p, q, False, **kw
        )
        got = engine.generate_walks_amortized(
            port, torch.from_numpy(start), jax_amortized_draws(key),
            walk_length, p, q, False, **kw,
        )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])


def _law_check(adj, walks, eff, p, q, min_checked=3, extend=False):
    counts = {}
    for row, m in zip(walks.numpy(), eff.numpy()):
        assert (row[m:] == row[m - 1]).all()  # resting emission
        for a, b in zip(row[: m - 1], row[1:m]):
            assert adj[a, b] != 0, f"non-edge {a}->{b}"
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
    assert checked >= min_checked, f"only {checked} transitions checkable"


def _draws(seed=0):
    return engine.TrialDrawStream(seed, 0, 2, "cpu")


def test_amortized_cdf_channel_law(rng):
    p, q = 0.5, 2.0
    adj = oracle.random_graph(rng, 8, mean_degree=5.0, weighted=True)
    g = device_csr_from_dense(adj, degree_cap=CAP, with_cdf=True, device="cpu")
    assert g.has_hubs and "cdf" in g.channels
    start = torch.from_numpy(rng.integers(0, 8, 6400).astype(np.int32))
    walks, eff = engine.generate_walks_amortized(g, start, _draws(3), 4, p, q, False)
    _law_check(adj, walks, eff, p, q)


@pytest.mark.parametrize("queued", [False, True])
def test_directed_asymmetric_law(rng, queued):
    """Asymmetric weights: ``symmetric`` is False, so the atom's return
    weight comes from a membership probe, never from the proposal."""
    p, q = 0.5, 2.0
    n = 9
    adj = oracle.random_graph(rng, n, mean_degree=6.0, weighted=True, directed=True)
    for i in range(n):
        if adj[i].sum() == 0:
            adj[i, (i + 1) % n] = 1.5
    g = device_csr_from_dense(adj, degree_cap=CAP, device="cpu")
    assert g.has_hubs and not g.symmetric
    start = torch.from_numpy(rng.integers(0, n, 6400).astype(np.int32))
    if queued:
        walks, eff = engine.generate_walks_queued(
            g, start, _draws(9), 4, p, q, False, lanes=512
        )
    else:
        walks, eff = engine.generate_walks_amortized(g, start, _draws(9), 4, p, q, False)
    _law_check(adj, walks, eff, p, q)


def test_queued_second_order_law_with_sink(rng):
    """Lanes << walks with a sink: death, claims, starts and resting
    emission through the queue; early stops only at the sink."""
    p, q = 0.5, 2.0
    n = 9
    adj = oracle.random_graph(rng, n, mean_degree=5.0, weighted=True)
    adj[n - 1, :] = 0
    g = device_csr_from_dense(adj, degree_cap=CAP, with_cdf=True, device="cpu")
    starts = rng.integers(0, n, 12000).astype(np.int32)
    walks, eff = engine.generate_walks_queued(
        g, torch.from_numpy(starts), _draws(3), 4, p, q, False, lanes=256
    )
    np.testing.assert_array_equal(walks[:, 0].numpy(), starts)
    short = eff.numpy() <= 4
    assert short.any()
    last = walks.numpy()[np.arange(starts.size), eff.numpy() - 1]
    assert (adj[last[short]].sum(1) == 0).all()
    _law_check(adj, walks, eff, p, q)


def test_queued_first_order_column(rng):
    """Column 1 of every queued walk (claimed mid-run too) follows the
    FIRST-order law w(start, .): the forced-accept trial."""
    n = 8
    adj = oracle.random_graph(rng, n, mean_degree=5.0, weighted=True)
    g = device_csr_from_dense(adj, degree_cap=CAP, with_cdf=True, device="cpu")
    u = int(np.argmax((adj > 0).sum(1)))
    walks, _ = engine.generate_walks_queued(
        g, torch.full((6000,), u, dtype=torch.int32), _draws(5), 3, 0.25, 4.0,
        False, lanes=128,
    )
    col1 = walks[:, 1].numpy()
    nbrs = np.nonzero(adj[u])[0]
    freq = np.array([(col1 == nb).mean() for nb in nbrs])
    np.testing.assert_allclose(
        freq, oracle.first_order_probs(adj, u), atol=4.5 * np.sqrt(0.25 / col1.size)
    )


@pytest.mark.parametrize("queued", [False, True])
def test_walk_length_one(rng, queued):
    adj = oracle.random_graph(rng, 10, mean_degree=8.0, weighted=True)
    g = device_csr_from_dense(adj, degree_cap=CAP, device="cpu")
    starts = torch.from_numpy(rng.integers(0, 10, 300).astype(np.int32))
    if queued:
        walks, eff = engine.generate_walks_queued(g, starts, _draws(), 1, 0.5, 2.0, False, lanes=64)
    else:
        walks, eff = engine.generate_walks_amortized(g, starts, _draws(), 1, 0.5, 2.0, False)
    assert walks.shape == (300, 2)
    np.testing.assert_array_equal(walks[:, 0].numpy(), starts.numpy())
    for (a, b), m in zip(walks.numpy(), eff.numpy()):
        assert m == (2 if adj[a].sum() > 0 else 1)
        assert adj[a, b] != 0 or m == 1


@pytest.mark.parametrize("queued", [True, False], ids=["queued", "amortized"])
def test_mode_early_termination_and_reproducible(rng, queued):
    """SparseOTF on a hub graph with a sink, through the mode (the queued
    engine) or the per-batch amortized engine on the mode's graph and
    start nodes: walks follow edges, stop only at the sink, and reproduce
    under one seed; no trial kernel runs on the CPU."""
    n = 9
    adj = oracle.random_graph(rng, n, mean_degree=5.0, weighted=True)
    adj[n - 1, :] = 0
    ids = [str(i) for i in range(n)]
    before = trialkernel.trial_propose.launches
    outs = []
    for _ in range(2):
        g = pecanpy.SparseOTF.from_mat(
            adj, ids, p=0.5, q=2.0, random_state=5, degree_cap=CAP, device="cpu",
            walker_batch=64,
        )
        if queued:
            outs.append(g.simulate_walks_device(40, 6))
        else:
            draws = engine.TrialDrawStream(5, 0, engine.HUB_TRIALS, "cpu")
            starts = torch.from_numpy(g._start_nodes(40))
            outs.append(engine.generate_walks_amortized(
                g.get_device_graph(), starts, draws, 6, 0.5, 2.0, False))
    walks, eff = outs[0]
    assert torch.equal(walks, outs[1][0]) and torch.equal(eff, outs[1][1])
    assert walks.shape == (40 * n, 7)
    for row, m in zip(walks.numpy(), eff.numpy()):
        for a, b in zip(row[: m - 1], row[1:m]):
            assert adj[a, b] != 0
        if m <= 6:
            assert adj[row[m - 1]].sum() == 0
    assert (eff.numpy() <= 6).any()
    assert trialkernel.trial_propose.launches == before


@pytest.mark.parametrize("mode", [pecanpy.SparseOTF, pecanpy.DenseOTF])
def test_mode_node2vec_plus_law(rng, mode):
    """node2vec+ (extend) on a hub graph: the plain trial block's law."""
    p, q = 1.0, 0.5
    adj = oracle.random_graph(rng, 8, mean_degree=5.0, weighted=True)
    g = mode.from_mat(
        adj, [str(i) for i in range(8)], p=p, q=q, extend=True, gamma=0.0,
        random_state=11, degree_cap=CAP, device="cpu",
    )
    assert g.get_device_graph().has_hubs
    walks, eff = g.simulate_walks_device(700, 4)
    _law_check(adj, walks, eff, p, q, extend=True)


def test_per_step_sampler_walks_hub_graph(rng, monkeypatch):
    """``PECANPY_TPU_AMORTIZED=0`` on a hub graph walks with the scan
    engine and the per-step sampler (tests/test_torch_stepsampler.py holds
    it against the JAX package), one batch per chunk and no cdf channel."""
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", "0")
    adj = oracle.random_graph(rng, 10, mean_degree=8.0, weighted=True)
    g = pecanpy.SparseOTF.from_mat(
        adj, [str(i) for i in range(10)], degree_cap=CAP, device="cpu"
    )
    dg = g.get_device_graph()
    assert dg.has_hubs and "cdf" not in dg.channels
    assert g._walk_queue_factor() == 1
    walks, eff = g.simulate_walks_device(1, 4)
    for row, m in zip(walks.numpy(), eff.numpy()):
        for a, b in zip(row[: m - 1], row[1:m]):
            assert adj[a, b] != 0, f"non-edge {a}->{b}"


def test_sbm_embed_with_hubs_micro_f1(rng):
    """The slice end to end: a block-model graph whose nodes are mostly
    hubs (degree_cap 6) embeds to micro-F1 >= 0.9."""
    adj, labels = sbm_graph(rng)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0, degree_cap=CAP, device="cpu")
    assert g.get_device_graph().has_hubs
    emb = g.embed(dim=32, num_walks=8, walk_length=30, window_size=5, epochs=3)
    f1 = micro_f1_nearest_centroid(emb, labels, rng)
    assert f1 >= 0.9, f"micro-F1 {f1:.3f} below 0.9"


def test_cli_degree_cap_reproducible(tmp_path, karate_edg):
    outs = []
    for i in range(2):
        out = tmp_path / f"k{i}.emb"
        cli.main([
            "--input", karate_edg, "--output", str(out), "--dimensions", "8",
            "--walk-length", "10", "--num-walks", "3", "--window-size", "4",
            "--p", "0.5", "--q", "2", "--random_state", "0", "--device", "cpu",
            "--degree-cap", "6",
        ])
        outs.append(out.read_bytes())
    lines = outs[0].decode().splitlines()
    assert lines[0] == "34 8" and len(lines) == 35
    assert outs[0] == outs[1]
