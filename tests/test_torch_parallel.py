"""The port's multi-rank training (``pecanpy_tpu_torch/parallel``) against
the JAX package's mesh, on gloo ranks on the CPU.

The port runs one process per rank (``parallel.launch.spawn``); the JAX
package one controller over the 8 virtual CPU devices of
``tests/conftest.py``. Inputs cross as numpy: the JAX tables go to the
ranks through ``MultichipTrainer.tables_from_numpy``, the walk uniforms
and ``StepDraws`` of each data rank come from the JAX key tree
(``fold_in(key, data index)``). Walks are compared on integer-weight
graphs, where every prefix sum is exact. Tolerance of one fused step:
rtol=1e-5, atol=1e-6 (f32 sums in another order, and the score sums over
two dim halves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import oracle
from pecanpy_tpu.models import sgns as jsgns
from pecanpy_tpu.ops.layout import device_csr_from_dense as jax_csr_from_dense
from pecanpy_tpu.parallel import distgraph as jdistgraph
from pecanpy_tpu.parallel import mesh as jmesh
from pecanpy_tpu.parallel import train as jtrain
from pecanpy_tpu_torch import cli, pecanpy
from pecanpy_tpu_torch.models import modes, sgns
from pecanpy_tpu_torch.ops import layout
from pecanpy_tpu_torch.parallel import distgraph, launch, mesh, train
from test_downstream import micro_f1_nearest_centroid, sbm_graph
from test_torch_sgns import jax_draws
from test_torch_walk import jax_walk_uniforms

N, DIM, WALK = 32, 16, 8
T = torch.from_numpy


def _int_graph(rng, n=N, mean_degree=4.0):
    """Weighted graph with integer weights 1..3 and no isolated node."""
    adj = np.ceil(oracle.random_graph(rng, n, mean_degree=mean_degree, weighted=True))
    for i in np.nonzero(adj.sum(1) == 0)[0]:
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.0
    return adj


# -- mesh and pure functions ---------------------------------------------------


@pytest.mark.parametrize("mp", [1, 2])
def test_mesh_grid_matches_jax(mp):
    grid = jmesh.make_mesh(8, model_parallel=mp).devices
    ids = np.vectorize(lambda d: d.id)(grid)
    ours = mesh.mesh_grid(8, mp)
    np.testing.assert_array_equal(ours, ids - ids.min())
    for r in range(8):  # rank r sits at (r // M, r % M)
        assert tuple(np.argwhere(ours == r)[0]) == (r // mp, r % mp)
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, model_parallel=3)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.mesh_grid(8, 3)


@pytest.mark.parametrize("partition,nbytes,shards,supported,budget", [
    ("auto", 2 << 20, 8, True, "1"),
    ("auto", 2 << 20, 1, True, "1"),
    ("auto", 2 << 20, 8, False, "1"),
    ("replicated", 10**15, 8, True, "1"),
    ("edge", 0, 8, True, "1"),
    ("auto", 2 << 20, 8, True, "4096"),
])
def test_resolve_partition_matches_jax(monkeypatch, partition, nbytes, shards, supported, budget):
    monkeypatch.setenv("PECANPY_TPU_REPLICATED_BUDGET_MB", budget)
    want = jtrain.resolve_partition(partition, nbytes, shards, mode_supported=supported)
    assert train.resolve_partition(partition, nbytes, shards, supported) == want


def test_replicated_budget_default_cpu(monkeypatch):
    monkeypatch.delenv("PECANPY_TPU_REPLICATED_BUDGET_MB", raising=False)
    assert train.replicated_budget_bytes("cpu") == train.CPU_REPLICATED_BUDGET_MB << 20


@pytest.mark.parametrize("b_local,shards,width", [
    (64, 2, 128), (4096, 2, 256), (4096, 8, 128), (65536, 4, 64), (1, 8, 64), (512, 16, 192),
])
def test_exchange_cost_model_matches_jax(b_local, shards, width):
    assert distgraph.exchange_cost_model(b_local, shards, width) == \
        jdistgraph.exchange_cost_model(b_local, shards, width)
    for ex in ("auto", "psum", "alltoall"):
        assert distgraph.resolve_exchange(ex, b_local, shards, width) == \
            jdistgraph.resolve_exchange(ex, b_local, shards, width)


@pytest.mark.parametrize("cap,cdf", [(None, False), (5, False), (5, True)])
def test_graph_table_bytes_matches_jax(rng, cap, cdf):
    adj = _int_graph(rng, 24, 8.0)
    ref = jax_csr_from_dense(adj, degree_cap=cap, with_cdf=cdf)
    port = layout.from_numpy(jax.tree.map(np.asarray, ref))
    assert layout.graph_table_bytes(port) == jtrain.graph_table_bytes(ref)


# -- one fused step against JAX --------------------------------------------------


@pytest.fixture(scope="module")
def fused_step_pair():
    """One fused step on a 32-node integer-weight graph: JAX on
    ``make_mesh(4, 2)``, the port on 4 gloo ranks (2 x 2) fed the JAX key
    tree's draws of each data index."""
    rng = np.random.default_rng(0)
    adj = _int_graph(rng)
    jgraph = jax_csr_from_dense(adj)
    config = sgns.SGNSConfig(dim=DIM, window=3, negative=2, seed=0, table_dtype="float32")
    jconfig = jsgns.SGNSConfig(dim=DIM, window=3, negative=2, seed=0, table_dtype="float32")
    m = jmesh.make_mesh(4, model_parallel=2)
    jt = jtrain.MultichipTrainer(mesh=m, graph=jgraph, config=jconfig, walk_length=WALK, p=0.5, q=2.0)
    w_in = (rng.standard_normal((N, DIM)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((N, DIM)) * 0.1).astype(np.float32)
    keep = rng.uniform(0.5, 1.0, N).astype(np.float32)
    neg_table = rng.integers(0, N, 256).astype(np.int32)
    starts = np.arange(N, dtype=np.int32).repeat(2)
    key, walk_key = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    lr = 0.025

    table_sharding = NamedSharding(m, P(None, "model"))
    want = jt.step(
        jax.device_put(jnp.asarray(w_in), table_sharding),
        jax.device_put(jnp.asarray(w_out), table_sharding),
        jt.shard_batch(starts), jnp.asarray(keep), jnp.asarray(neg_table), lr, key,
        walk_key=walk_key,
    )
    b = starts.size // 2
    walk_u, step_d, counts = [], [], np.zeros(N, np.float32)
    for d in range(2):
        kw = jax.random.fold_in(walk_key, d)
        walk_u.append(jax_walk_uniforms(kw, WALK, b))
        step_d.append(jax_draws(jax.random.fold_in(key, d), b, WALK + 1, config, neg_table.size))
        walks, eff = jt._walk(jt.graph, jnp.asarray(starts[d * b:(d + 1) * b]), kw)
        counts += np.asarray(jsgns._count_tokens(walks, eff, N))

    port = layout.from_numpy(jax.tree.map(np.asarray, jgraph))
    got = launch.spawn(
        train.run_fused_step, 4,
        (port, config, WALK, (w_in, w_out), starts, keep, neg_table, lr),
        dict(walk_draws=walk_u, step_draws=step_d, p=0.5, q=2.0),
        model_parallel=2, device="cpu",
    )
    return [np.asarray(w) for w in want], counts, got, w_out


def test_fused_step_matches_jax(fused_step_pair):
    want, _, got, w_out = fused_step_pair
    for r in got:  # every rank gathers the same tables
        np.testing.assert_array_equal(r["w_in"], got[0]["w_in"])
    np.testing.assert_allclose(got[0]["w_in"], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0]["w_out"], want[1], rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[0]["w_out"], w_out)  # the step moved W_out


def test_count_tokens_matches_jax(fused_step_pair):
    """The count pass over the step's batch equals the JAX trainer's counts
    of the same walks (the sum of its data shards' counts), exactly."""
    _, counts, got, _ = fused_step_pair
    np.testing.assert_array_equal(got[0]["counts"], counts)
    assert counts.sum() > 0


# -- replicated == edge ------------------------------------------------------------


@pytest.mark.parametrize("hubs", [False, True])
def test_edge_step_bitwise_equals_replicated(rng, hubs):
    """One step of the port's own draws on 2 x 2 ranks: the edge partition
    changes where rows live, never which rows come back."""
    if hubs:  # hub graph with the cdf channel: trial kernels == plain block
        adj = oracle.random_graph(rng, 24, mean_degree=8.0, weighted=True)
        graph = layout.device_csr_from_dense(adj, degree_cap=5, with_cdf=True, device="cpu")
        assert graph.has_hubs
    else:
        adj = oracle.random_graph(rng, N, mean_degree=4.0, weighted=True)
        graph = layout.device_csr_from_dense(adj, device="cpu")
    n = adj.shape[0]
    config = sgns.SGNSConfig(dim=DIM, window=3, negative=2, seed=0, table_dtype="float32")
    tables = tuple((rng.standard_normal((n, DIM)) * 0.1).astype(np.float32) for _ in range(2))
    kw = dict(graph=graph, config=config, walk_length=6, tables=tables,
              starts=np.arange(n, dtype=np.int32).repeat(2), keep_prob=np.ones(n, np.float32),
              neg_table=np.arange(n, dtype=np.int32), lr=0.025, p=0.5, q=2.0, seed=3)
    calls = [(train.run_fused_step, (), dict(kw, partition=part))
             for part in ("replicated", "edge")]
    rep, edge = launch.spawn(launch.run_calls, 4, (calls,), model_parallel=2, device="cpu")[0]
    for k in ("w_in", "w_out", "counts"):
        np.testing.assert_array_equal(rep[k], edge[k])
    assert not np.array_equal(rep["w_out"], tables[1])


# -- streaming trainer: resume, refusal ---------------------------------------------


def test_multichip_resume_byte_equal(rng, tmp_path):
    adj = oracle.random_graph(rng, 20, mean_degree=5.0, weighted=True)
    graph = layout.device_csr_from_dense(adj, device="cpu")
    config = sgns.SGNSConfig(dim=DIM, window=3, negative=2, seed=5, table_dtype="float32")
    targs = (graph, config, 6, 0.5, 2.0, False, modes.SparseOTF, "replicated")
    starts = np.tile(np.arange(20, dtype=np.int32), 6)
    ck = str(tmp_path / "ck")
    base = dict(trainer_args=targs, starts=starts, seed=5, epochs=2, batch=40)
    calls = [
        (train.embed_rank, (), base),
        (train.embed_rank, (), dict(base, checkpoint_dir=ck, checkpoint_every=1, max_steps=3)),
        (train.embed_rank, (), dict(base, checkpoint_dir=ck, checkpoint_every=1)),
    ]
    full, part, resumed = launch.spawn(launch.run_calls, 2, (calls,), device="cpu")[0]
    np.testing.assert_array_equal(full, resumed)
    assert not np.array_equal(full, part)
    # a multi-rank snapshot is refused by the single-device trainer
    walks = np.tile(np.arange(20, dtype=np.int32)[:, None], (1, 7))
    with pytest.raises(ValueError, match="RNG scheme"):
        sgns.train(T(walks), T(np.full(20, 7, np.int32)), 20, config, checkpoint_dir=ck)


def test_multichip_refuses_single_device_snapshot(rng, tmp_path):
    adj = oracle.random_graph(rng, 12, mean_degree=4.0, weighted=True)
    config = sgns.SGNSConfig(dim=8, window=2, negative=2, seed=0, table_dtype="float32")
    ck = str(tmp_path / "single")
    walks = np.tile(np.arange(12, dtype=np.int32)[:, None], (1, 5))
    sgns.train(T(walks), T(np.full(12, 5, np.int32)), 12, config,
               checkpoint_dir=ck, checkpoint_every=1, max_steps=1)
    graph = layout.device_csr_from_dense(adj, device="cpu")
    targs = (graph, config, 4, 1.0, 1.0, False, modes.SparseOTF, "replicated")
    with pytest.raises(Exception, match="RNG scheme"):
        launch.spawn(train.embed_rank, 1, (targs, np.arange(12, dtype=np.int32)),
                     dict(seed=0, checkpoint_dir=ck), device="cpu")


# -- the entry points ------------------------------------------------------------


def test_embed_auto_partition_edge_quality(rng, monkeypatch, capsys):
    """A graph over the (forced tiny) replication budget resolves to edge
    and still recovers its communities."""
    monkeypatch.setenv("PECANPY_TPU_REPLICATED_BUDGET_MB", "0")
    adj, labels = sbm_graph(rng, blocks=4, per_block=30)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0, device="cpu")
    emb = g.embed(dim=32, num_walks=6, walk_length=20, window_size=5, epochs=3,
                  n_devices=2, verbose=True)
    assert "partition: edge" in capsys.readouterr().out
    assert emb.shape == (120, 32)
    f1 = micro_f1_nearest_centroid(emb, labels, rng)
    assert f1 >= 0.8, f"micro-F1 {f1:.3f} below 0.8"


def test_embed_edge_equals_replicated(rng):
    adj = oracle.random_graph(rng, 20, mean_degree=5.0, weighted=True)
    ids = [str(i) for i in range(20)]

    def run(partition):
        g = pecanpy.SparseOTF.from_mat(adj, ids, p=0.5, q=2.0, random_state=7, device="cpu")
        return g.embed(dim=16, num_walks=4, walk_length=8, window_size=3,
                       n_devices=2, partition=partition)

    rep, edge = run("replicated"), run("edge")
    assert rep.shape == (20, 16) and np.isfinite(edge).all() and edge.std() > 0.0
    np.testing.assert_array_equal(rep, edge)


def test_embed_multichip_guards(karate_edg):
    g = pecanpy.SparseOTF(random_state=0, device="cpu")
    g.read_edg(karate_edg, weighted=False, directed=False)
    with pytest.raises(ValueError, match="does not divide"):
        g.embed(dim=4, num_walks=1, walk_length=3, n_devices=4, model_parallel=3)
    pc = pecanpy.PreComp(random_state=0, device="cpu")
    pc.read_edg(karate_edg, weighted=False, directed=False)
    with pytest.raises(Exception, match="no multichip trainer path"):
        pc.embed(dim=4, num_walks=1, walk_length=3, n_devices=2, partition="replicated")


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--devices", "4", "--model-parallel", "2", "--partition", "edge"],
])
def test_cli_devices(karate_edg, tmp_path, flags):
    out = tmp_path / "k.emb.npz"
    cli.main(["--input", karate_edg, "--output", str(out), "--dimensions", "8",
              "--walk-length", "5", "--num-walks", "2", "--window-size", "3",
              "--random_state", "0", "--device", "cpu", *flags])
    data = np.load(out)["data"]
    assert data.shape == (34, 8) and np.isfinite(data).all()
