"""Edge-partitioned walks of the port (``parallel/distgraph.py``) against
the JAX package's ``simulate_walks_distributed``, on 2 gloo ranks.

Both sides split the starts over two data shards; the port's ranks are
fed the JAX key tree's draws of their shard (``fold_in(key, shard)``):
the scan engine's uniforms on a graph without hubs, and on a hub graph
the amortized walker's rounds, recorded in this process through the
port's local walker (the rounds a rank runs past its own last one, while
the other rank still walks, are drawn for its final nodes). Integer
weights keep every prefix sum exact, so the walks must agree bit for bit,
under the psum exchange, the all-to-all exchange, and an all-to-all whose
capacity forces many rounds.
"""
import jax
import numpy as np
import pytest
import torch

from pecanpy_tpu.ops.layout import device_csr_from_dense as jax_csr_from_dense
from pecanpy_tpu.parallel import distgraph as jdistgraph
from pecanpy_tpu.parallel import mesh as jmesh
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import layout
from pecanpy_tpu_torch.parallel import distgraph, launch
from test_torch_hubs import int_hub_graph
from test_torch_hubwalk import jax_amortized_draws
from test_torch_walk import jax_walk_uniforms

P, Q, L, SEED, SHARDS = 0.5, 2.0, 6, 7, 2
CASES = [("psum", None), ("alltoall", None), ("alltoall", 2)]


def _record_hub_draws(port, starts, key_of):
    """Per shard: the JAX amortized walker's rounds as the port's local
    walker consumes them, padded to the slowest shard's round count."""
    b = starts.size // SHARDS
    recs, walks = [], []
    for d in range(SHARDS):
        base = jax_amortized_draws(key_of(d))
        rounds = {}

        def draws(t, deg, base=base, rounds=rounds):
            got = base(t, deg)
            rounds[t] = (got.kk.numpy(), got.u.numpy())
            return got

        w, e, r = engine.generate_walks_amortized(
            port, torch.from_numpy(starts[d * b:(d + 1) * b]), draws, L, P, Q, False,
            return_rounds=True,
        )
        recs.append((rounds, r, base, w))
        walks.append(w.numpy())
    r_max = max(r for _, r, _, _ in recs)
    for rounds, r, base, w in recs:
        deg = port.rows_degree(port.gather_rows(w[:, -1]))
        for t in range(r, r_max):
            got = base(t, deg)
            rounds[t] = (got.kk.numpy(), got.u.numpy())
    return [rec[0] for rec in recs], np.concatenate(walks)


@pytest.fixture(scope="module")
def walk_runs():
    rng = np.random.default_rng(0)
    mesh2 = jmesh.make_mesh(SHARDS)
    key = jax.random.PRNGKey(SEED)
    out = {}
    calls = []
    for name, cap in (("plain", None), ("hubs", 5)):
        adj = int_hub_graph(rng, n=24)
        jgraph = jax_csr_from_dense(adj, degree_cap=cap)
        assert jgraph.has_hubs == (cap is not None)
        port = layout.from_numpy(jax.tree.map(np.asarray, jgraph))
        starts = np.tile(np.arange(24, dtype=np.int32), 4)
        want, want_eff = jdistgraph.simulate_walks_distributed(
            jgraph, mesh2, starts, L, P, Q, seed=SEED, exchange="psum"
        )
        b = starts.size // SHARDS
        if cap is None:
            draws = [jax_walk_uniforms(jax.random.fold_in(key, d), L, b) for d in range(SHARDS)]
            local = None
        else:
            draws, local = _record_hub_draws(port, starts, lambda d: jax.random.fold_in(key, d))
        out[name] = dict(adj=adj, want=(np.asarray(want), np.asarray(want_eff)), local=local)
        for exchange, capacity in CASES:
            calls.append((distgraph.simulate_walks_distributed,
                          (port,), dict(starts=starts, walk_length=L, p=P, q=Q, seed=SEED,
                                        exchange=exchange, capacity=capacity, _draws=draws)))
    idx = rng.integers(0, 24, (SHARDS, 40)).astype(np.int32)
    for exchange, capacity in CASES:
        calls.append((distgraph.fetch_rows, (port,), dict(idx=idx, exchange=exchange, capacity=capacity)))
    out["fetch"] = dict(want=port.fused[torch.from_numpy(idx).long()].numpy())
    results = launch.spawn(launch.run_calls, SHARDS, (calls,), device="cpu")
    got = iter(zip(*results))  # per call: (rank 0's rows, rank 1's rows)
    for name in ("plain", "hubs"):
        for case in CASES:
            parts = next(got)
            out[name][case] = tuple(
                np.concatenate([p[i].numpy() for p in parts]) for i in (0, 1)
            )
    for case in CASES:
        out["fetch"][case] = np.stack([p.numpy() for p in next(got)])
    return out


@pytest.mark.parametrize("case", CASES, ids=["psum", "alltoall", "alltoall-cap2"])
def test_collective_fetch_equals_local_gather(walk_runs, case):
    """Each rank's fetched rows are the rows a local gather returns, bit
    for bit (the hub graph's fused rows carry int32 ids as denormals)."""
    fetch = walk_runs["fetch"]
    np.testing.assert_array_equal(fetch[case].view(np.int32), fetch["want"].view(np.int32))


@pytest.mark.parametrize("case", CASES, ids=["psum", "alltoall", "alltoall-cap2"])
@pytest.mark.parametrize("graph", ["plain", "hubs"])
def test_distributed_walks_equal_jax(walk_runs, graph, case):
    run = walk_runs[graph]
    walks, eff = run[case]
    np.testing.assert_array_equal(walks, run["want"][0])
    np.testing.assert_array_equal(eff, run["want"][1])


def test_hub_recording_matches_jax(walk_runs):
    """The local walker that recorded the hub draws reproduces JAX's
    distributed walks itself (the draws are the JAX key tree's)."""
    run = walk_runs["hubs"]
    np.testing.assert_array_equal(run["local"], run["want"][0])


@pytest.mark.parametrize("graph", ["plain", "hubs"])
def test_distributed_walks_follow_edges(walk_runs, graph):
    run = walk_runs[graph]
    for case in CASES:
        walks, eff = run[case]
        assert walks.shape == (96, L + 1)
        for row, m in zip(walks, eff):
            for a, b in zip(row[: m - 1], row[1:m]):
                assert run["adj"][a, b] != 0, f"{case}: non-edge {a}->{b}"


def test_shard_rows_pads_and_splits():
    table = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    parts = [layout.shard_rows(table, 2, s, pad_value=-1.0) for s in range(2)]
    assert [rows for _, rows in parts] == [3, 3]
    np.testing.assert_array_equal(
        torch.cat([p for p, _ in parts]).numpy(),
        np.concatenate([table.numpy(), [[-1.0, -1.0]]]),
    )
