"""Fused-row layout of the PyTorch port against the JAX package.

The port must build the fused rows bit for bit (int32 ids bitcast into
f32 lanes, 64-lane padding, the sentinel ``num_nodes``), so every row is
compared through its int32 view: exact equality, no tolerance.
"""
import jax
import numpy as np
import pytest
import torch

import oracle
from pecanpy_tpu.graph import SparseGraph as JaxSparseGraph
from pecanpy_tpu.ops import layout as jlayout
from pecanpy_tpu_torch.graph import SparseGraph
from pecanpy_tpu_torch.ops import layout


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def assert_same_layout(port: layout.DeviceCSR, ref) -> None:
    """Bitwise equality of every table and every static field."""
    assert port.channels == tuple(ref.channels)
    assert port.dpad == ref.dpad
    assert port.max_degree == ref.max_degree
    assert port.symmetric == ref.symmetric
    assert not ref.has_hubs and not port.has_hubs
    for name in ("fused", "threshold"):
        np.testing.assert_array_equal(
            _bits(getattr(port, name).numpy()), _bits(getattr(ref, name))
        )
    for name in ("deg", "indptr"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        )


def _csr(adj):
    rows, cols = np.nonzero(adj)
    deg = np.bincount(rows, minlength=adj.shape[0])
    return np.concatenate([[0], np.cumsum(deg)]), cols, adj[rows, cols]


def _graphs():
    rng = np.random.default_rng(0)
    weighted = oracle.random_graph(rng, 40, mean_degree=6.0, weighted=True)
    directed = oracle.random_graph(rng, 30, mean_degree=4.0, directed=True)
    directed[3, :] = 0  # a sink
    return {"weighted": weighted, "directed": directed}


@pytest.mark.parametrize("with_thr", [False, True])
def test_karate_rows_bitwise(karate_edg, with_thr):
    g = SparseGraph()
    g.read_edg(karate_edg, weighted=False, directed=False)
    jg = JaxSparseGraph()
    jg.read_edg(karate_edg, weighted=False, directed=False, engine="python")
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    port = layout.build_device_csr(
        g.indptr, g.indices, g.data, with_thresholds=with_thr, device="cpu"
    )
    ref = jlayout.build_device_csr(
        jg.indptr, jg.indices, jg.data, with_thresholds=with_thr,
        to_device=False,
    )
    assert_same_layout(port, ref)
    # ids decode only through the int32 view; the sentinel pads each row
    assert int(port.nbr[0, int(port.deg[0])]) == port.num_nodes


@pytest.mark.parametrize("name", ["weighted", "directed"])
@pytest.mark.parametrize("with_thr", [False, True])
def test_random_graph_rows_bitwise(name, with_thr):
    adj = _graphs()[name]
    indptr, indices, data = _csr(adj)
    port = layout.build_device_csr(
        indptr, indices, data, gamma=0.5, with_thresholds=with_thr,
        device="cpu",
    )
    ref = jlayout.build_device_csr(
        indptr, indices, data, gamma=0.5, with_thresholds=with_thr,
        to_device=False,
    )
    assert_same_layout(port, ref)
    assert port.symmetric == (name == "weighted")


@pytest.mark.parametrize("name", ["weighted", "directed"])
def test_dense_rows_bitwise(name):
    adj = _graphs()[name]
    port = layout.device_csr_from_dense(adj, with_thresholds=True, device="cpu")
    ref = jlayout.device_csr_from_dense(adj, with_thresholds=True, to_device=False)
    assert_same_layout(port, ref)


def test_hub_graph_raises(monkeypatch):
    """A node above degree_cap becomes a hub row (a marker, no padding to
    its degree); only the uncapped layout, padded to the true max degree,
    raises once it exceeds the fused byte budget."""
    n = 200
    adj = np.zeros((n, n))
    adj[0, 1:] = adj[1:, 0] = 1.0  # star: node 0 has degree 199 > 128
    indptr, indices, data = _csr(adj)
    dg = layout.build_device_csr(indptr, indices, data, device="cpu")
    assert dg.has_hubs and dg.dpad == 128  # the cap, not the hub's degree
    assert int(dg.nbr[0, 0]) == n + 1 + 199 and dg.rows_degree(dg.fused[:1]).item() == 199
    assert dg.edge_pack.shape == (-(-199 // layout.EP_SUPER), layout.SUPER_W)
    # uncapped, the same graph packs (padded to the true max degree) ...
    dg = layout.build_device_csr(
        indptr, indices, data, degree_cap=None, device="cpu"
    )
    assert dg.dpad == 256 and not dg.has_hubs
    # ... unless that padding exceeds the byte budget
    monkeypatch.setenv("PECANPY_TPU_FUSED_BUDGET_MB", "0")
    with pytest.raises(ValueError, match="degree_cap"):
        layout.build_device_csr(indptr, indices, data, degree_cap=None, device="cpu")


def test_from_numpy_carries_jax_layout():
    adj = _graphs()["weighted"]
    ref = jlayout.device_csr_from_dense(adj, with_thresholds=True)
    port = layout.from_numpy(jax.tree.map(np.asarray, ref))
    assert_same_layout(port, jax.tree.map(np.asarray, ref))
    assert port.fused.dtype == torch.float32
    nbr = port.rows_nbr(port.gather_rows(torch.arange(3)))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(ref.nbr)[:3])
