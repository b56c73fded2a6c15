"""The port's last public surface against the JAX package's, on the CPU.

The reference compat callbacks of every mode (``get_noise_thresholds``,
``get_has_nbrs``, ``get_move_forward``), the alias sampler, the
index-taking weight wrappers, ``checkpointing_available``, the CLI's
stage functions and the packaging of the ``pecanpy-tpu-torch`` console
script. Tolerances: thresholds, degrees, alias indices and draws equal,
alias thresholds Q within 1 ulp (the port adds each row's total in the
order the jitted JAX sum adds it, so they agree to the bit here); first-order and node2vec weights equal, node2vec+ and
node2vec++ weights rtol 1e-6 (``row_thresholds`` and the bias divisions
reduce in another order, as in ``tests/test_torch_walk.py``); the
``move_forward`` law within 5 binomial sigma of ``tests/oracle.py``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_compat.py -q
"""
import fnmatch
import importlib
import pathlib
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from pecanpy_tpu import pecanpy as jax_pecanpy
from pecanpy_tpu import typing as jax_typing
from pecanpy_tpu.ops import layout as jlayout
from pecanpy_tpu.ops import sampling as jsampling
from pecanpy_tpu.ops import transition as jtransition
from pecanpy_tpu_torch import cli, pecanpy
from pecanpy_tpu_torch import typing as port_typing
from pecanpy_tpu_torch.native import loader
from pecanpy_tpu_torch.ops import _kernels, layout, sampling, transition
from pecanpy_tpu_torch.utils import checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]
T = torch.from_numpy
LAW_SIGMAS = 5.0
LAW_CALLS = 2000


def _ids(n):
    return [str(i) for i in range(n)]


def _int_graph(rng, n, mean_degree):
    adj = np.ceil(oracle.random_graph(rng, n, mean_degree=mean_degree))
    for i in np.nonzero(adj.sum(1) == 0)[0]:  # every node has an edge
        j = (i + 1) % n
        adj[i, j] = adj[j, i] = 1.0
    return adj


def _hub_graph(rng, n=60):
    """Undirected integer-weight graph whose nodes 0 and 1 have degree
    above 20; walked with ``degree_cap=6`` they are hubs."""
    adj = _int_graph(rng, n, 4.0)
    for hub in (0, 1):
        nbrs = rng.choice(np.arange(2, n), 20, replace=False)
        adj[hub, nbrs] = adj[nbrs, hub] = rng.integers(1, 4, 20)
    return adj


# -- typing and checkpointing --------------------------------------------------


def test_typing_aliases_as_in_jax():
    """Every name of the JAX ``__all__`` but the jax array alias."""
    assert set(port_typing.__all__) == set(jax_typing.__all__) - {"JaxArray"}
    for name in port_typing.__all__:
        assert getattr(port_typing, name) == getattr(jax_typing, name), name


def test_checkpointing_available():
    assert checkpoint.checkpointing_available() is True


# -- the compat callbacks --------------------------------------------------------


def test_noise_thresholds_equal_jax(rng):
    adj = oracle.random_graph(rng, 40, mean_degree=6.0)
    kw = dict(p=0.5, q=2.0, extend=True, gamma=0.5, random_state=0)
    got = pecanpy.SparseOTF.from_mat(adj, _ids(40), device="cpu", **kw)
    want = jax_pecanpy.SparseOTF.from_mat(adj, _ids(40), **kw)
    thr = got.get_noise_thresholds()
    assert thr.shape == (40,) and thr.dtype == np.float32
    np.testing.assert_array_equal(thr, want.get_noise_thresholds())


def test_has_nbrs_equal_jax_on_a_directed_graph_with_a_sink(rng):
    adj = oracle.random_graph(rng, 30, mean_degree=3.0, directed=True)
    adj[7] = 0.0  # node 7 has no out-edge
    adj[3, 7] = 1.0  # and an in-edge
    got = pecanpy.SparseOTF.from_mat(adj, _ids(30), device="cpu").get_has_nbrs()
    want = jax_pecanpy.SparseOTF.from_mat(adj, _ids(30)).get_has_nbrs()
    assert [got(i) for i in range(30)] == [want(i) for i in range(30)]
    assert not got(7) and [got(i) for i in range(30)] == list(adj.sum(1) > 0)


@pytest.mark.parametrize("hubs", [False, True])
def test_move_forward_law(hubs, rng):
    """Every result is a neighbor of cur; the law of the second-order step
    from a (cur, prev) pair within 5 sigma of the node2vec law. With hubs
    cur is a hub, so the step runs the per-step rejection sampler at one
    lane."""
    p, q = 0.5, 2.0
    if hubs:
        adj, cap = _hub_graph(rng), 6
    else:
        adj, cap = _int_graph(rng, 40, 6.0), None
    cur = int(np.argmax((adj != 0).sum(1)))  # a hub on the hub graph
    g = pecanpy.SparseOTF.from_mat(
        adj, _ids(adj.shape[0]), p=p, q=q, degree_cap=cap, random_state=1, device="cpu"
    )
    assert g.get_device_graph().has_hubs == hubs
    move_forward = g.get_move_forward()
    nbrs = np.nonzero(adj[cur])[0]
    prev = int(nbrs[0])
    got = np.array([move_forward(cur, prev) for _ in range(LAW_CALLS)])
    assert np.isin(got, nbrs).all()
    freq = (got[:, None] == nbrs[None, :]).mean(0)
    law = oracle.node2vec_probs(adj, cur, prev, p, q)
    assert np.abs(freq - law).max() <= LAW_SIGMAS * np.sqrt(0.25 / LAW_CALLS)
    first = [move_forward(c) for c in range(adj.shape[0]) for _ in range(3)]
    starts = np.repeat(np.arange(adj.shape[0]), 3)
    assert (adj[starts, first] != 0).all()


def test_move_forward_same_seed_same_sequence(rng):
    adj = _hub_graph(rng)
    edges = np.transpose(np.nonzero(adj))[rng.choice(int((adj != 0).sum()), 100)]

    def run(seed):
        g = pecanpy.SparseOTF.from_mat(
            adj, _ids(60), p=0.5, q=2.0, degree_cap=6, random_state=seed, device="cpu"
        )
        move_forward = g.get_move_forward()
        return [move_forward(int(c), int(pv)) for pv, c in edges]

    first = run(4)
    assert run(4) == first
    assert run(5) != first
    assert all(adj[c, x] != 0 for (_, c), x in zip(edges, first))


# -- the alias sampler -----------------------------------------------------------


def _alias_rows(rng, r, d, integer):
    deg = rng.integers(0, d + 1, r).astype(np.int32)
    deg[:4] = [0, 1, d, d]
    w = rng.uniform(0.0, 3.0, (r, d)).astype(np.float32)
    if integer:
        w = np.round(w)
    w[np.arange(d)[None, :] >= deg[:, None]] = 0.0
    return w, deg


@pytest.mark.parametrize("d,integer", [(7, True), (24, False), (70, False)])
def test_alias_build_equals_jax(d, integer, rng):
    w, deg = _alias_rows(rng, 96, d, integer)
    want_j, want_q = jax.jit(jsampling.alias_build)(jnp.asarray(w), jnp.asarray(deg))
    got_j, got_q = sampling.alias_build(T(w), T(deg))
    assert got_j.dtype == torch.int32 and got_q.dtype == torch.float32
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
    ulps = np.abs(
        got_q.numpy().view(np.int32).astype(np.int64)
        - np.asarray(want_q).view(np.int32).astype(np.int64)
    )
    assert ulps.max() <= 1


def test_alias_draw_equals_jax_on_its_draws(rng):
    w, deg = _alias_rows(rng, 50, 16, False)
    alias_j, alias_q = jax.jit(jsampling.alias_build)(jnp.asarray(w), jnp.asarray(deg))
    b = 4096
    row = rng.integers(0, 50, b).astype(np.int32)
    degree = deg[row]
    key = jax.random.PRNGKey(3)
    want = jsampling.alias_draw(key, alias_j, alias_q, jnp.asarray(row), jnp.asarray(degree))
    # the JAX function's own draws, from the same split keys
    k_int, k_unif = jax.random.split(key)
    kk = jax.random.randint(k_int, (b,), 0, jnp.maximum(jnp.asarray(degree), 1))
    u = jax.random.uniform(k_unif, (b,))
    got = sampling.alias_draw(
        T(np.array(alias_j)), T(np.array(alias_q)), T(row), T(np.array(kk)), T(np.array(u))
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the index-taking weight wrappers ------------------------------------------------


def test_index_weight_wrappers_equal_jax(rng):
    adj = oracle.random_graph(rng, 30, mean_degree=6.0)
    ref = jlayout.device_csr_from_dense(adj, gamma=0.5, with_thresholds=True)
    dg = layout.from_numpy(jax.tree.map(np.asarray, ref))
    cur = rng.integers(0, 30, 64).astype(np.int32)
    prev = np.array([rng.choice(np.nonzero(adj[c])[0]) for c in cur]).astype(np.int32)
    jc, jp, tc, tp = jnp.asarray(cur), jnp.asarray(prev), T(cur), T(prev)
    np.testing.assert_array_equal(
        transition.first_order_weights(dg, tc).numpy(),
        np.asarray(jtransition.first_order_weights(ref, jc)),
    )
    for p, q in [(0.5, 2.0), (2.0, 0.5), (1.0, 1.0)]:
        np.testing.assert_array_equal(
            transition.node2vec_weights(dg, tc, tp, p, q).numpy(),
            np.asarray(jtransition.node2vec_weights(ref, jc, jp, p, q)),
        )
        np.testing.assert_allclose(
            transition.node2vec_plus_weights(dg, tc, tp, p, q).numpy(),
            np.asarray(jtransition.node2vec_plus_weights(ref, jc, jp, p, q)),
            rtol=1e-6, atol=0,
        )
        np.testing.assert_allclose(
            transition.node2vec_plus_weights(dg, tc, tp, p, q, gamma=1.0).numpy(),
            np.asarray(jtransition.node2vec_plus_weights(ref, jc, jp, p, q, gamma=1.0)),
            rtol=1e-6, atol=0,
        )
        np.testing.assert_allclose(
            transition.node2vec_pp_weights(dg, tc, tp, p, q).numpy(),
            np.asarray(jtransition.node2vec_pp_weights(ref, jc, jp, p, q)),
            rtol=1e-6, atol=0,
        )


# -- the CLI's stage functions and the packaging ---------------------------------------


def test_cli_stages_byte_equal_to_embed(tmp_path, karate_edg, capsys):
    """The non-streaming embedding task walks in ``simulate_walks`` and
    trains in ``learn_embeddings``, printing the JAX CLI's stage names,
    and writes what one ``embed`` call gives."""
    out = tmp_path / "k.emb"
    with pytest.warns(UserWarning, match="epochs=1 on a small corpus"):  # embed's advisory
        cli.main([
            "--input", karate_edg, "--output", str(out), "--dimensions", "16",
            "--walk-length", "10", "--num-walks", "3", "--window-size", "4",
            "--p", "0.5", "--q", "2", "--random_state", "0", "--verbose",
            "--device", "cpu",
        ])
    text = capsys.readouterr().out
    for stage in ("load Graph", "pre-compute transition probabilities",
                  "generate walks", "train embeddings"):
        assert f" to {stage}\n" in text, stage
    assert "walks + train embeddings" not in text
    g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=0, device="cpu")
    g.read_edg(karate_edg, False, False, "\t")
    want = tmp_path / "embed.emb"
    cli.save_embeddings(str(want), g.nodes, g.embed(
        dim=16, num_walks=3, walk_length=10, window_size=4, streaming=False))
    assert out.read_bytes() == want.read_bytes()


def test_console_script_and_package_data():
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    target = meta["project"]["scripts"]["pecanpy-tpu-torch"]
    assert target == "pecanpy_tpu_torch.cli:main"
    module, func = target.split(":")
    assert getattr(importlib.import_module(module), func) is cli.main
    data = meta["tool"]["setuptools"]["package-data"]

    def shipped(package, directory):
        """Files of ``directory`` the package's globs name, relative to
        the package's own directory."""
        root = REPO / package.replace(".", "/")
        names = [str(f.relative_to(root)) for f in directory.iterdir()]
        return {n for glob in data[package] for n in fnmatch.filter(names, glob)}

    native = shipped("pecanpy_tpu_torch.native", loader.NATIVE_DIR)
    assert {src.name for src in loader.SOURCES} <= native
    csrc = shipped("pecanpy_tpu_torch", _kernels.CSRC_DIR)
    kernel_sources = {
        f"csrc/{f.name}" for pattern in ("*.cu", "*.cuh") for f in _kernels.CSRC_DIR.glob(pattern)
    }
    assert kernel_sources and kernel_sources <= csrc
