"""The port's native host library against the JAX package's.

Both packages compile the same C++ sources (``native/*.cpp``) with the
same ``g++`` flags; the port builds its copy into ``build/``. So every
comparison here is bitwise unless it says otherwise:

* the edgelist parser: CSR, node IDs and the summary warnings equal the
  JAX native parser's; CSR and IDs equal the port's Python parser's;
* the hub-table builder: every table equals the JAX native builder's;
  the hash tables also equal the Python builders', and the alias rows
  imply the same neighbour law within 1e-6;
* the sequential SGNS trainer at one thread and the reference walker at
  one thread: the same arrays in, the same arrays out;
* ``train_sequential`` and ``embed(trainer="sequential")`` on the CPU.
"""
import warnings

import numpy as np
import pytest

from pecanpy_tpu import graph as jgraph
from pecanpy_tpu.models import sgns as jsgns
from pecanpy_tpu.native import loader as jloader
from pecanpy_tpu_torch import cli, graph, pecanpy
from pecanpy_tpu_torch.models import sgns
from pecanpy_tpu_torch.native import loader
from pecanpy_tpu_torch.ops import hubs
from test_downstream import micro_f1_nearest_centroid, sbm_graph


def write(path, rows, delimiter="\t", blank_lines=False):
    with open(path, "w") as f:
        for r in rows:
            f.write(delimiter.join(str(x) for x in r) + "\n")
            if blank_lines:
                f.write("\n\n")
    return str(path)


EDGELISTS = {
    # name: (rows, weighted, directed, delimiter, blank lines)
    "weighted": ([("a", "b", 1.5), ("b", "c", 2.0), ("c", "a", 0.25), ("a", "d", 3)],
                 True, False, "\t", False),
    "weighted_directed": ([("a", "b", 1.5), ("b", "c", 2.0), ("c", "a", 0.25), ("a", "d", 3)],
                          True, True, "\t", False),
    "unweighted": ([("x", "y"), ("y", "z"), ("z", "x")], False, False, "\t", False),
    "delimiter": ([("a", "b", 2.0), ("b", "c", 1.0)], True, False, ",", False),
    "nonpositive": ([("a", "b", 1.0), ("b", "c", -1.0), ("c", "d", 0.0), ("d", "a", 0.5)],
                    True, False, "\t", False),
    "duplicates": ([("a", "b", 1.0), ("a", "b", 5.0), ("b", "c", 2.0), ("b", "c", 2.0)],
                   True, False, "\t", False),
    "blank_lines": ([("a", "b", 1.0), ("b", "c", 2.0), ("c", "e", 0.125)],
                    True, True, "\t", True),
}


def parse(module, engine, path, weighted, directed, delimiter):
    """(graph, [(category, message)] of the warnings it raised)."""
    g = module.SparseGraph()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g.read_edg(path, weighted, directed, delimiter, engine=engine)
    return g, [(w.category, str(w.message)) for w in caught]


def assert_same_csr(a, b):
    assert a.nodes == b.nodes
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32), err_msg=name)


@pytest.mark.parametrize("case", sorted(EDGELISTS) + ["karate"])
def test_native_parser_matches_jax_and_python(case, tmp_path, karate_edg):
    """The port's native parser equals the JAX native parser (CSR, IDs,
    summary warnings) and the port's Python parser (CSR, IDs), bitwise."""
    if case == "karate":
        path, weighted, directed, delim = karate_edg, False, False, "\t"
    else:
        rows, weighted, directed, delim, blank = EDGELISTS[case]
        path = write(tmp_path / "g.edg", rows, delim, blank)
    port, port_warn = parse(graph, "native", path, weighted, directed, delim)
    ref, ref_warn = parse(jgraph, "native", path, weighted, directed, delim)
    assert_same_csr(port, ref)
    assert port_warn == ref_warn
    if case != "blank_lines":  # the Python parser, as the reference's, rejects them
        assert_same_csr(port, parse(graph, "python", path, weighted, directed, delim)[0])
    if case == "nonpositive":
        assert port_warn == [(RuntimeWarning, "Non-positive edge ignored: 2 edge(s) dropped")]
    if case == "duplicates":
        assert len(port_warn) == 1 and "duplicate" in port_warn[0][1]
        row_a = slice(port.indptr[0], port.indptr[1])
        assert port.data[row_a][port.indices[row_a] == 1][0] == 5.0
    if case == "blank_lines":
        assert port.num_nodes == 4 and port.num_edges == 3  # directed


def test_native_parser_errors_and_engines(tmp_path, monkeypatch):
    """Malformed files raise ValueError; ``engine="auto"`` uses the native
    parser; without the library ``"native"`` raises and ``"auto"`` takes
    the Python parser."""
    g = graph.SparseGraph()
    with pytest.raises(ValueError, match="three columns"):
        g.read_edg(write(tmp_path / "two.edg", [("a", "b")]), True, False, engine="native")
    with pytest.raises(ValueError, match="weight"):
        g.read_edg(write(tmp_path / "bad.edg", [("a", "b", "oops")]), True, False,
                   engine="native")
    path = write(tmp_path / "g.edg", [("a", "b", 1.0), ("b", "c", -1.0)])
    with pytest.warns(RuntimeWarning, match="1 edge\\(s\\) dropped"):  # the summary
        g.read_edg(path, True, False)
    monkeypatch.setattr(loader, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native parser unavailable"):
        g.read_edg(path, True, False, engine="native")
    with pytest.warns(RuntimeWarning, match="Non-positive edge ignored: w\\(b,c\\)"):
        g.read_edg(path, True, False)  # per-edge warning of the Python parser
    assert g.nodes == ["a", "b"]


def test_library_builds_into_build_dir():
    """The library lives in the repo's git-ignored ``build/`` under a name
    hashed from its sources, never beside them."""
    assert loader.native_available()
    path = loader.library_path()
    assert path.parent == loader.BUILD_DIR and path.exists()
    assert loader.BUILD_DIR.name == "build"
    assert loader.BUILD_DIR.parent == loader.NATIVE_DIR.parent.parent
    assert not list(loader.NATIVE_DIR.glob("*.so"))


# -- the hub-table builder ----------------------------------------------------


def hub_graph(rng, n=300, hubs_n=6, cap=64):
    """A float-weight undirected graph whose first ``hubs_n`` nodes have
    degrees far above the rest, as a sorted CSR plus the ids of the nodes
    above ``cap``."""
    adj = (rng.random((n, n)) < 0.03) * rng.uniform(0.1, 3.0, (n, n))
    adj[:hubs_n] = (rng.random((hubs_n, n)) < 0.6) * rng.uniform(0.1, 3.0, (hubs_n, n))
    adj = np.triu(adj, 1)
    adj = adj + adj.T
    rows, cols = np.nonzero(adj)
    deg = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    hub_ids = np.nonzero(deg > cap)[0].astype(np.int32)
    assert hub_ids.size >= hubs_n
    return indptr, cols, adj[rows, cols].astype(np.float32), hub_ids


def alias_law(edge_pack, hub_base, counts):
    """Per hub, the neighbour law its alias rows imply: P(x) = (sum of the
    acceptances of x's slots + the rejections aliased to x) / degree."""
    packi = edge_pack.view(np.int32)
    laws = []
    for base, k in zip(hub_base, counts):
        rows = edge_pack[base : base + k]
        law = {}
        for r, ri in zip(rows, packi[base : base + k]):
            law[ri[1]] = law.get(ri[1], 0.0) + float(r[0]) / k
            law[ri[3]] = law.get(ri[3], 0.0) + (1.0 - float(r[0])) / k
        laws.append(law)
    return laws


def test_hub_builder_matches_jax_native(rng):
    """Every table of the port's native builder equals the JAX native
    builder's, bitwise; the hash tables equal the Python builders', and
    each hub's alias rows imply the Python builders' law within 1e-6."""
    indptr, indices, data, hub_ids = hub_graph(rng)
    port = loader.build_hub_tables_native(indptr, indices, data, hub_ids)
    ref = jloader.build_hub_tables_native(indptr, indices, data, hub_ids)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert hubs.build_hub_structures(indptr, indices, data, hub_ids)[0].tobytes() == (
        port[0].tobytes())
    py = hubs.build_python(indptr, indices, data, hub_ids)
    for i in (1, 2, 3, 4, 5):  # hub_base, hkey8, hval8, bucket_base, bucket_log
        np.testing.assert_array_equal(port[i].view(np.uint8), py[i].view(np.uint8))
    counts = indptr[hub_ids + 1] - indptr[hub_ids]
    for law_n, law_p, lo, k in zip(alias_law(port[0], port[1], counts),
                                   alias_law(py[0], py[1], counts), indptr[hub_ids], counts):
        w = data[lo : lo + k].astype(np.float64)
        exact = dict(zip(indices[lo : lo + k], w / w.sum()))
        for law in (law_n, law_p):
            assert law.keys() == exact.keys()
            assert max(abs(law[x] - exact[x]) for x in exact) < 1e-6


# -- the sequential SGNS trainer --------------------------------------------


def seq_inputs(rng, n=40, dim=16, w=30, t=21):
    walks = rng.integers(0, n, (w, t), dtype=np.int32)
    eff = rng.integers(2, t + 1, w).astype(np.int32)
    w_in = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    keep = np.clip(rng.random(n).astype(np.float32) + 0.5, 0, 1)
    neg = rng.integers(0, n, 256, dtype=np.int32)
    return walks, eff, w_in, w_out, keep, neg


def test_sequential_native_matches_jax(rng):
    """One thread: both libraries train the same tables bit for bit."""
    walks, eff, w_in0, w_out0, keep, neg = seq_inputs(rng)
    total = float(eff.sum()) * 2
    out = []
    for lib in (loader, jloader):
        w_in, w_out = w_in0.copy(), w_out0.copy()
        pairs = lib.train_sgns_sequential_native(
            walks, eff, w_in, w_out, keep, neg, 4, 3, 0.05, 0.001, total, 2, 99,
            workers=1)
        out.append((pairs, w_in, w_out))
    assert out[0][0] == out[1][0] > 0
    for a, b in zip(out[0][1:], out[1][1:]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    with pytest.raises(ValueError, match="outside"):
        bad = walks.copy()
        bad[0, 0] = w_in0.shape[0]
        loader.train_sgns_sequential_native(
            bad, eff, w_in0.copy(), w_out0.copy(), keep, neg, 4, 3, 0.05, 0.001,
            total, 2, 99)


def test_train_sequential_matches_jax(rng):
    """``train_sequential`` against JAX's on the same walks, one thread:
    the keep probabilities (torch here, jnp there) and the whole run agree
    to the bit (tolerance 0)."""
    n = 50
    walks = rng.integers(0, n, (60, 16), dtype=np.int32)
    eff = rng.integers(3, 17, 60).astype(np.int32)
    config = sgns.SGNSConfig(dim=12, window=3, epochs=2, seed=5)
    jconfig = jsgns.SGNSConfig(dim=12, window=3, epochs=2, seed=5)
    port = sgns.train_sequential(walks, eff, n, config, workers=1)
    ref = jsgns.train_sequential(walks, eff, n, jconfig, workers=1)
    assert port.shape == (n, 12) and port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


def test_sequential_trains_communities(rng):
    """The sequential trainer learns the block-model graph from the port's
    walks (micro-F1 >= 0.9, the JAX suite's gate)."""
    adj, labels = sbm_graph(rng)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0, device="cpu")
    walks, eff = g.simulate_walks_device(8, 30)
    walks, eff = walks.numpy(), eff.numpy()
    n, dim = g.num_nodes, 32
    counts = np.bincount(walks[np.arange(31)[None, :] < eff[:, None]], minlength=n)
    neg_table = sgns.build_negative_table(counts, size=1 << 16, seed=0)
    w_in = np.random.default_rng(0).uniform(-0.5 / dim, 0.5 / dim, (n, dim)).astype(np.float32)
    w_out = np.zeros((n, dim), dtype=np.float32)
    loader.train_sgns_sequential_native(
        walks, eff, w_in, w_out, np.ones(n, np.float32), neg_table,
        5, 5, 0.025, 0.0001, float(eff.sum()) * 3, 3, 7,
    )
    f1 = micro_f1_nearest_centroid(w_in, labels, rng)
    assert f1 >= 0.9, f"sequential trainer micro-F1 {f1:.3f} below 0.9"


# -- the reference walker ------------------------------------------------------


def test_refwalker_matches_jax(rng):
    """One thread, one seed: both libraries walk the same walks."""
    indptr, indices, data, _ = hub_graph(rng, n=80, hubs_n=2, cap=20)
    starts = rng.integers(0, 80, 400).astype(np.int32)
    port = loader.walk_node2vec_native(indptr, indices, data, starts, 15, 0.5, 2.0, seed=3)
    ref = jloader.walk_node2vec_native(indptr, indices, data, starts, 15, 0.5, 2.0, seed=3)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    walks, eff = port
    assert (walks[:, 0] == starts).all() and (eff == 16).all()
    a, b = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    edge = np.zeros((80, 80), dtype=bool)
    edge[np.repeat(np.arange(80), np.diff(indptr)), indices] = True
    assert edge[a, b].all()


# -- entry points ----------------------------------------------------------------


def test_embed_trainer_sequential(karate_edg):
    """embed(trainer='sequential') on karate, two hogwild threads."""
    g = pecanpy.SparseOTF(random_state=0, workers=2, device="cpu")
    g.read_edg(karate_edg, weighted=False, directed=False)
    emb = g.embed(dim=8, num_walks=2, walk_length=10, window_size=3, trainer="sequential")
    assert emb.shape == (34, 8) and emb.dtype == np.float32
    assert np.isfinite(emb).all() and np.abs(emb).sum() > 0


@pytest.mark.parametrize("kwargs", [
    dict(n_devices=2), dict(streaming=True), dict(checkpoint_dir="ck"),
])
def test_embed_sequential_guards(kwargs, karate_edg):
    g = pecanpy.SparseOTF(random_state=0, device="cpu")
    g.read_edg(karate_edg, weighted=False, directed=False)
    with pytest.raises(ValueError, match="sequential"):
        g.embed(dim=4, num_walks=1, walk_length=5, trainer="sequential", **kwargs)


def test_cli_trainer_sequential(karate_edg, tmp_path):
    """``--trainer sequential --workers 2`` writes one row per karate node."""
    out = tmp_path / "s.emb"
    cli.main(["--input", karate_edg, "--output", str(out), "--dimensions", "4",
              "--walk-length", "5", "--num-walks", "2", "--p", "0.5",
              "--random_state", "0", "--device", "cpu", "--trainer", "sequential",
              "--workers", "2"])
    lines = out.read_text().splitlines()
    assert lines[0] == "34 4" and len(lines) == 35
    assert all(np.isfinite([float(v) for v in line.split()[1:]]).all() for line in lines[1:])
