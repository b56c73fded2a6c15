"""The queued hub engine's CUDA-graph rule, on the CPU.

``engine.generate_walks_queued`` replays its blocks of rounds from one
captured CUDA graph only on a card, on the plain trial block's route
(node2vec+), on a graph held whole and with its own ``TrialDrawStream``
(``engine._replays_rounds``). Here each of those conditions alone keeps
it eager: no capture is tried, the counters ``walk.hub_graph_*`` stay 0,
and the walks are those of the engine run eagerly. With the card stubbed
in and the capture replaced by a replay that runs the captured block
again, the graph path's static lanes, block boundary and generator
hand-off give the eager walks bit for bit on the CPU too. The card's own
capture is tested in ``test_torch_kernels.py`` (marker ``gpu``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import rejection
from pecanpy_tpu_torch.ops.layout import DeviceCSR, device_csr_from_dense
from pecanpy_tpu_torch.utils import trace

WALK_LENGTH = 9
LANES = 64
BLOCK = 4


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.reset()
    keys = set(engine._ROUND_GRAPHS)
    yield
    trace.reset()
    # a fake capture's replay holds its block, and so its graph
    for key in set(engine._ROUND_GRAPHS) - keys:
        del engine._ROUND_GRAPHS[key]


def _graph(seed, directed=False):
    """A 60-node weighted graph whose degree cap (the median degree) makes
    about half the nodes hubs."""
    gen = np.random.default_rng(seed)
    n = 60
    adj = (gen.random((n, n)) < 0.15).astype(np.float64)
    if not directed:
        adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    w = gen.integers(1, 4, (n, n)) + gen.random((n, n))
    adj = adj * (w if directed else np.triu(w) + np.triu(w, 1).T)
    for i in np.nonzero(adj.sum(1) == 0)[0]:
        adj[i, (i + 1) % n] = 1.0
    cap = int(np.median((adj > 0).sum(1)))
    dg = device_csr_from_dense(adj, degree_cap=cap, with_cdf=True, device="cpu")
    assert dg.has_hubs and dg.symmetric != directed
    return dg


def _starts(dg):
    return torch.arange(dg.num_nodes, dtype=torch.int32).repeat(5)


def _walk(dg, draws, p=0.5, q=0.5, extend=True):
    return engine.generate_walks_queued(
        dg, _starts(dg), draws, WALK_LENGTH, p, q, extend, lanes=LANES,
        return_rounds=True, block_rounds=BLOCK)


def _assert_same(got, want):
    (w_g, e_g, r_g), (w_w, e_w, r_w) = got, want
    assert torch.equal(w_g, w_w) and torch.equal(e_g, e_w) and r_g == r_w


def _fake_capture(self, fn):
    """The capture replaced by a replay that runs the block again."""
    return types.SimpleNamespace(replay=fn)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("p,q", [(0.5, 0.5), (0.25, 2.0)])  # atom off / on
def test_graph_path_equals_eager_with_the_card_stubbed(monkeypatch, p, q, directed):
    """Two chunks, then the first again: one capture, every block after
    the first a replay, walks and the draw streams' states as eager."""
    dg = _graph(3, directed)

    def calls():
        streams = [engine.TrialDrawStream(11, c, 2, "cpu") for c in (0, 1, 0)]
        with trace.job("pecanpy.test_hubgraph"):
            out = [_walk(dg, s, p, q) for s in streams]
        return out, [s.gen.get_state() for s in streams], trace.last_job(
            "pecanpy.test_hubgraph")

    want, want_states, rec = calls()
    assert rec.counter("walk.hub_graph_captures") == 0
    monkeypatch.setattr(engine, "_on_card", lambda graph: True)
    monkeypatch.setattr(engine._GraphedRounds, "_capture", _fake_capture)
    got, got_states, rec = calls()
    for g, w in zip(got, want):
        _assert_same(g, w)
    _assert_same(got[2], got[0])
    assert all(torch.equal(a, b) for a, b in zip(got_states, want_states))
    rounds = sum(r for _, _, r in got)
    assert rec.counter("walk.hub_rounds") == rounds > 3 * BLOCK
    assert rec.counter("walk.hub_graph_captures") == 1
    # the first block under the key ran eagerly
    assert rec.counter("walk.hub_graph_rounds") == rounds - BLOCK


class _Synced(DeviceCSR):
    """A graph that reports a loop sync, as a row-sharded one does."""

    @property
    def loop_sync(self):
        return lambda n: n


@pytest.mark.parametrize("case", ["cpu", "injected_draws", "loop_sync", "kernel_route"])
def test_each_condition_alone_keeps_the_rounds_eager(monkeypatch, case):
    dg = _graph(5)
    extend = case != "kernel_route"

    def draws():
        stream = engine.TrialDrawStream(13, 0, 2, "cpu")
        return (lambda t, deg: stream(t, deg)) if case == "injected_draws" else stream

    if case == "loop_sync":
        dg = _Synced(**{f.name: getattr(dg, f.name) for f in dataclasses.fields(dg)})
    if case == "kernel_route":  # the trial kernels' wrappers take their plain versions
        monkeypatch.setattr(rejection, "use_trial_kernels", lambda extend, graph: True)
    want = _walk(dg, draws(), extend=extend)

    def no_capture(*args, **kwargs):
        raise AssertionError("a capture was tried")

    monkeypatch.setattr(engine, "_GraphedRounds", no_capture)
    if case != "cpu":
        monkeypatch.setattr(engine, "_on_card", lambda graph: True)
    assert not engine._replays_rounds(dg, draws(), extend)
    with trace.job("pecanpy.test_hubgraph"):
        got = _walk(dg, draws(), extend=extend)
    rec = trace.last_job("pecanpy.test_hubgraph")
    _assert_same(got, want)
    assert rec.counter("walk.hub_rounds") == got[2] > 0
    assert rec.counter("walk.hub_graph_captures") == 0
    assert rec.counter("walk.hub_graph_rounds") == 0


def test_one_round_graph_a_graph_and_key(monkeypatch):
    """Chunks and calls under one key share an entry; other p, q take
    another. (That an entry goes with its graph is tested on the card: a
    fake capture's replay holds the block, and so the graph.)"""
    monkeypatch.setattr(engine, "_on_card", lambda graph: True)
    monkeypatch.setattr(engine._GraphedRounds, "_capture", _fake_capture)
    before = len(engine._ROUND_GRAPHS)
    dg = _graph(7)
    for chunk in (0, 1):
        _walk(dg, engine.TrialDrawStream(1, chunk, 2, "cpu"))
    assert len(engine._ROUND_GRAPHS) == before + 1
    _walk(dg, engine.TrialDrawStream(1, 0, 2, "cpu"), p=0.25, q=2.0)
    assert len(engine._ROUND_GRAPHS) == before + 2
