"""PreComp's tables against the benchmark's plain reference, its walks
against the law the reference's rows give, and the job and counters its
build and steps leave in the port's tracing.

The reference (``portbench/reference/precomp_table.py``) is loaded by
path: it imports only torch and numpy, and nothing of the port, so the
tables it builds are worked out again from the CSR triple in float64.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.ops import transition
from pecanpy_tpu_torch.utils import trace

_REF_PATH = (Path(__file__).resolve().parent.parent / "portbench" / "reference"
             / "precomp_table.py")
_spec = importlib.util.spec_from_file_location("precomp_table_reference", _REF_PATH)
ref_lib = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_lib)

# (nodes, edge probability, undirected, p, q, PRECOMP_WIDTH or None)
CASES = {
    "undirected": (60, 0.15, True, 0.5, 2.0, None),
    "directed": (60, 0.15, False, 0.7, 1.9, None),
    "narrow": (60, 0.25, True, 0.5, 2.0, 8),
}


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.reset()
    yield
    trace.reset()


def _adj(n, p_edge, undirected, seed=5):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < p_edge) * rng.uniform(0.2, 3.0, (n, n))
    np.fill_diagonal(adj, 0.0)
    if undirected:
        adj = np.triu(adj) + np.triu(adj, 1).T
    for i in np.nonzero((adj != 0).sum(1) == 0)[0]:  # every node has an out-edge
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.5
    return adj


def _csr(adj):
    rows, cols = np.nonzero(adj)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=adj.shape[0]))])
    return indptr.astype(np.int64), cols.astype(np.int64), adj[rows, cols].astype(np.float32)


def _mode(case, **kwargs):
    n, p_edge, undirected, p, q, width = CASES[case]
    adj = _adj(n, p_edge, undirected)
    g = pecanpy.PreComp.from_mat(adj, [str(i) for i in range(n)], p=p, q=q, device="cpu",
                                 **kwargs)
    if width is not None:
        g.PRECOMP_WIDTH = width
    return g, adj, ref_lib.PrecompReference(*_csr(adj), p, q)


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_table_equals_the_reference(case):
    g, _, ref = _mode(case)
    g.preprocess_transition_probs()
    dg = g.get_device_graph()
    width = min(g.PRECOMP_WIDTH, transition._active_width(dg))
    assert tuple(g.edge_cdf.shape) == (ref.num_edges, width)
    if case == "narrow":
        assert ref.max_degree > width  # rows cut to the table: the fallback's nodes
    # a float32 prefix sum of at most max-degree terms and one division
    atol = ref_lib.f32_cdf_atol(ref.max_degree)
    gap, pad_faults = ref_lib.table_gaps(ref.edge_rows, g.edge_cdf, block=500)
    assert gap <= atol and pad_faults == 0, (gap, atol, pad_faults)
    # the tolerance catches the next precision down: the table in bfloat16
    gap16, _ = ref_lib.table_gaps(ref.edge_rows, g.edge_cdf.to(torch.bfloat16), block=500)
    assert gap16 > 10 * atol, (gap16, atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_first_order_channel_equals_the_reference(case):
    g, _, ref = _mode(case)
    dg = g.get_device_graph()
    first = dg.rows_cdf(dg.fused)
    # float64 on the host, rounded once to float32: half an ulp of 1.0
    gap, pad_faults = ref_lib.table_gaps(ref.node_rows, first, block=17)
    assert gap <= ref_lib.F32_ROUNDED_ATOL and pad_faults == 0, (gap, pad_faults)
    gap16, _ = ref_lib.table_gaps(ref.node_rows, first.to(torch.bfloat16))
    assert gap16 > 10 * ref_lib.F32_ROUNDED_ATOL


@pytest.mark.parametrize("case,walks,length", [("full", 600, 4), ("narrow", 400, 5)])
def test_walks_follow_the_reference_law(case, walks, length):
    """Next-node frequencies after (prev, cur), and from a first step's
    cur, within 4.5 binomial sigma of the reference rows' probabilities
    (the full rows, also where the program's table is narrower)."""
    if case == "full":
        adj = _adj(12, 0.3, True, seed=7)
        width = None
    else:
        adj = _adj(20, 0.6, True, seed=8)
        width = 8
    n = adj.shape[0]
    g = pecanpy.PreComp.from_mat(adj, [str(i) for i in range(n)], p=0.5, q=2.0,
                                 random_state=3, device="cpu")
    if width:
        g.PRECOMP_WIDTH = width
    ref = ref_lib.PrecompReference(*_csr(adj), 0.5, 2.0)
    if width:
        assert ref.max_degree > width
    full = ref.max_degree
    walks_t, eff = g.simulate_walks_device(walks, length)
    assert bool((eff == length + 1).all())
    w = walks_t.numpy()

    def probs(rows):
        cdf = rows[0][0].numpy()
        return np.diff(np.concatenate([[0.0], cdf]))

    keys = ref.keys.numpy()
    checked = 0
    contexts = {}
    for row in w:
        contexts.setdefault((None, row[0]), []).append(row[1])
        for j in range(2, length + 1):
            contexts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    for (prev, cur), nxts in contexts.items():
        if len(nxts) < 150:
            continue
        if prev is None:
            pr = probs(ref.node_rows(cur, cur + 1, full))
        else:
            e = int(np.searchsorted(keys, cur * n + prev))
            pr = probs(ref.edge_rows(e, e + 1, full))
        nbrs = ref.col[ref.indptr[cur]:ref.indptr[cur + 1]].numpy()
        freq = np.array([(np.asarray(nxts) == v).mean() for v in nbrs])
        np.testing.assert_allclose(freq, pr[:nbrs.size], atol=4.5 * np.sqrt(0.25 / len(nxts)),
                                   err_msg=str((prev, cur)))
        checked += 1
    assert checked >= 10, checked


@pytest.mark.parametrize("case", ["undirected", "narrow"])
def test_build_job_and_step_counters(case, monkeypatch):
    monkeypatch.setenv("PECANPY_TPU_PRECOMP_BUILD_MB", "0")  # 256-edge slices
    g, _, ref = _mode(case, walker_batch=32)
    g.get_device_graph()
    g._preprocess_transition_probs()  # as the walk driver builds it, once
    job = trace.last_job("pecanpy.precomp")
    e, w = g.edge_cdf.shape
    assert job.counter("precomp.table_bytes") == e * w * 4
    assert job.counter("precomp.build_slices") == -(-ref.num_edges // 256) > 1
    # the edge count read once, and the wait for the finished table
    assert job.counter(trace.SYNCS) == 2
    assert job.span("pecanpy.walk.edges_read").count == 1
    assert job.span("pecanpy.precomp.ready").count == 1

    num_walks, length = 2, 6
    g.simulate_walks_device(num_walks, length)
    walks_job = trace.last_job("pecanpy.walks")
    chunks = walks_job.span("pecanpy.walk.chunk").count
    assert chunks == -(-60 * num_walks // 32)
    steps = walks_job.counter("walk.precomp_steps")
    assert steps == chunks * (length - 1)
    assert walks_job.counter("walk.precomp_lane_steps") == 60 * num_walks * (length - 1)
    fallback = walks_job.counter("walk.precomp_fallback_steps")
    if case == "narrow":
        assert fallback == steps > 0
    else:
        assert fallback == 0
    assert walks_job.span("pecanpy.precomp").count == 0  # built before the call


def test_build_inside_a_job_is_a_span_of_it():
    g, _, _ = _mode("undirected")
    g.get_device_graph()
    g.simulate_walks_device(1, 4)  # the first walk call builds the table
    assert trace.last_job("pecanpy.precomp") is None
    job = trace.last_job("pecanpy.walks")
    assert job.span("pecanpy.precomp").count == 1
    assert job.counter("precomp.table_bytes") == g.edge_cdf.numel() * 4
