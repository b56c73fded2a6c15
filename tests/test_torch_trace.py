"""The port's spans and counters (``pecanpy_tpu_torch/utils/trace.py``).

The registry's arithmetic (nesting, totals, ``wait_ns``, the job bound,
jobs inside jobs), the ``profiled`` flag, the promise that a profiler
sees no ``pecanpy.`` range unless tracing is enabled, the enabled log's
clock against the profiler's own events, and the counts of two real
calls on the CPU: an ``embed`` job counts exactly its chunk-steps and its
syncs, and a hub walk's ``walk.hub_rounds`` equals the rounds the queued
engine reports.
"""
import math
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chip_smoke import small_hub_graph
from profile_port import span_labels
from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.models import engine, sgns
from pecanpy_tpu_torch.utils import trace

PKG = Path(__file__).resolve().parent.parent / "pecanpy_tpu_torch"


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.reset()
    trace.disable()
    yield
    trace.disable()
    trace.reset()


def test_span_nesting_totals_and_wait():
    with trace.job("pecanpy.test.job"):
        with trace.span("pecanpy.test.outer"):
            with trace.span("pecanpy.test.inner"):
                with trace.sync("pecanpy.test.sync"):
                    time.sleep(0.002)
                time.sleep(0.001)
            with trace.sync("pecanpy.test.sync"):
                time.sleep(0.002)
        trace.count("test.n", 3)
        trace.count("test.n")
    (rec,) = trace.jobs()
    assert rec.name == "pecanpy.test.job" and not rec.profiled
    sync, inner, outer = (rec.span(f"pecanpy.test.{k}") for k in ("sync", "inner", "outer"))
    job = rec.span("pecanpy.test.job")
    assert sync.count == 2 and sync.wait_ns == sync.total_ns >= 4_000_000
    assert inner.count == 1 and outer.count == 1 and job.count == 1
    # wait: the syncs nested at any depth, and nothing else
    assert outer.wait_ns == sync.total_ns and job.wait_ns == sync.total_ns
    assert 0 < inner.wait_ns < sync.total_ns
    assert inner.dispatch_ns >= 1_000_000
    assert job.total_ns >= outer.total_ns >= inner.total_ns + sync.total_ns - inner.wait_ns
    assert rec.wall_ns == job.total_ns
    assert rec.counter(trace.SYNCS) == 2 and rec.counter("test.n") == 4
    assert rec.counter("test.absent") == 0


def test_spans_outside_a_job_count_nowhere_and_exceptions_unwind():
    with trace.span("pecanpy.test.free"):
        trace.count("test.n")
    with pytest.raises(ValueError):
        with trace.job("pecanpy.test.job"):
            with trace.span("pecanpy.test.inner"):
                raise ValueError("boom")
    with trace.job("pecanpy.test.after"):
        pass
    recs = trace.jobs()
    assert [r.name for r in recs] == ["pecanpy.test.job", "pecanpy.test.after"]
    assert recs[0].span("pecanpy.test.inner").count == 1
    assert recs[1].spans.keys() == {"pecanpy.test.after"}


def test_job_bound_and_nested_jobs():
    for i in range(trace.MAX_JOBS + 6):
        with trace.job("pecanpy.test.outer"):
            trace.count("test.i", i)
            with trace.job("pecanpy.test.nested"):  # a span of the outer job
                trace.count("test.nested")
    recs = trace.jobs()
    assert len(recs) == trace.MAX_JOBS
    assert [r.counter("test.i") for r in recs] == list(range(6, trace.MAX_JOBS + 6))
    assert {r.name for r in recs} == {"pecanpy.test.outer"}
    assert all(r.span("pecanpy.test.nested").count == 1 for r in recs)
    assert all(r.counter("test.nested") == 1 for r in recs)
    assert trace.last_job("pecanpy.test.nested") is None
    trace.reset()
    assert trace.jobs() == []


def test_device_scalar_counter_is_read_on_demand():
    with trace.job("pecanpy.test.job"):
        trace.count("test.steps", torch.tensor(7))
        trace.count("test.steps", torch.tensor(5))
        trace.count("test.steps", -2)
    assert trace.last_job().counter("test.steps") == 10


def test_profiled_set_under_torch_profiler():
    with trace.job("pecanpy.test.plain"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.job("pecanpy.test.profiled"):
            pass
    plain, profiled = trace.jobs()
    assert not plain.profiled and profiled.profiled
    assert not trace.is_enabled()  # a running profiler enables nothing


def _tiny_mode(karate_edg, **kw):
    g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=3, device="cpu", **kw)
    g.read_edg(karate_edg, weighted=False, directed=False)
    return g


EMBED = dict(dim=8, num_walks=2, walk_length=10, window_size=3, epochs=2)


def test_no_port_event_in_a_profile_unless_enabled(karate_edg):
    g = _tiny_mode(karate_edg)
    g.get_device_graph()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.embed(**EMBED)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not [n for n in names if n.startswith(trace.PREFIX)]
    assert trace.last_job("pecanpy.embed").profiled
    assert trace.spans() == []


def test_enabled_spans_share_the_profiler_clock(karate_edg):
    g = _tiny_mode(karate_edg)
    g.get_device_graph()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # a profile's first event pays its set-up
            pass
        g.embed(**EMBED)
    trace.disable()
    logged = trace.spans()
    assert logged and trace.dropped() == 0
    assert all(r.name.startswith(trace.PREFIX) and 0 < r.start_ns <= r.end_ns for r in logged)
    job_id = trace.last_job("pecanpy.embed").id
    assert {r.job for r in logged} == {job_id}
    assert logged[0].name == "pecanpy.embed" and logged[0].parent == -1
    assert all(0 <= r.parent < i for i, r in enumerate(logged) if i)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            events.setdefault(e.name(), []).append(e.start_ns())
    for name, starts in events.items():
        mine = [r.start_ns for r in logged if r.name == name]
        assert len(mine) == len(starts), name
        gaps = np.abs(np.array(mine) - np.array(sorted(starts)))
        assert gaps.max() < 100_000, (name, int(gaps.max()))
    # profile_port.py's labeller finds the innermost span around a time
    at = span_labels(logged)
    step = next(r for r in logged if r.name == "pecanpy.sgns.draw")
    assert at((step.start_ns + step.end_ns) // 2) == "pecanpy.sgns.draw"
    assert at(logged[0].start_ns - 1) is None


@pytest.mark.parametrize("streaming", [False, True])
def test_embed_job_counts_its_chunk_steps_and_syncs(karate_edg, streaming):
    g = _tiny_mode(karate_edg)
    g.get_device_graph()  # the layout's uploads are the job pecanpy.layout
    layout_syncs = trace.last_job("pecanpy.layout").counter(trace.SYNCS)
    assert layout_syncs == 4  # fused, deg, threshold, indptr: no hub tables
    g.embed(**EMBED, streaming=streaming)
    rec = trace.last_job("pecanpy.embed")
    walks = g.num_nodes * EMBED["num_walks"]
    config = sgns.SGNSConfig(dim=EMBED["dim"], window=EMBED["window_size"])
    chunk = min(sgns.resolve_batch_walks(config, g.num_nodes, EMBED["walk_length"] + 1),
                walks)
    steps = math.ceil(walks / chunk) * EMBED["epochs"]
    for name in ("pecanpy.sgns.chunk_step", "pecanpy.sgns.draw", "pecanpy.sgns.body"):
        assert rec.span(name).count == steps, name
    assert rec.span("pecanpy.sgns.epoch").count == EMBED["epochs"]
    chunks = rec.span("pecanpy.walk.chunk").count
    assert chunks == rec.span("pecanpy.walk.start_upload").count >= 1
    # the CPU tables take the scatter path and a small chunk no negative
    # pool: the syncs are the starts, the vocabulary's reads and upload
    # (and the streaming trainer's token total and cached lengths), and
    # the table's read
    assert rec.counter(trace.SYNCS) == chunks + (5 if streaming else 4)
    assert rec.span("pecanpy.sgns.buffer").count == (EMBED["epochs"] if streaming else 0)
    total = rec.span("pecanpy.embed")
    assert total.total_ns >= rec.span("pecanpy.sgns.epoch").total_ns > 0


@pytest.mark.parametrize("mode", [pecanpy.SparseOTF, pecanpy.DenseOTF])
@pytest.mark.parametrize("num_walks", [2, 20])  # walks below / above 1,024
def test_hub_walk_counts_the_queued_engine_rounds(num_walks, mode):
    adj = small_hub_graph(np.random.default_rng(4))
    g = mode.from_mat(adj, [str(i) for i in range(adj.shape[0])], p=0.5, q=2.0,
                      random_state=7, degree_cap=6, device="cpu")
    dg = g.get_device_graph()
    assert dg.has_hubs and trace.last_job("pecanpy.layout") is not None
    walks, eff = g.simulate_walks_device(num_walks, 12)
    rec = trace.last_job("pecanpy.walks")

    # the same chunk through the engine itself
    starts = torch.from_numpy(g._start_nodes(num_walks))
    draws = engine.TrialDrawStream(g._seed(), 0, 2, g.device)
    want_w, want_e, rounds = engine.generate_walks_queued(
        dg, starts, draws, 12, 0.5, 2.0, False, lanes=g._resolved_walker_batch(),
        block_rounds=16, return_rounds=True)
    assert torch.equal(walks, want_w) and torch.equal(eff, want_e)
    lanes = min(g._resolved_walker_batch(), starts.numel())
    assert rec.counter("walk.hub_rounds") == rounds > 0
    assert rec.counter("walk.hub_lane_rounds") == rounds * lanes
    assert rec.counter("walk.hub_steps") == int((eff.long() - 1).sum())
    blocks = rec.span("pecanpy.walk.hub_block").count
    assert blocks == rounds // 16 == rec.span("pecanpy.walk.pending_read").count
    # the chunk's start upload, the queue cursor's upload, one read a block
    assert rec.counter(trace.SYNCS) == 2 + blocks


def test_amortized_hub_engine_counts_rounds_and_steps():
    # the per-batch engine (the multi-rank hub walker's), called in a job:
    # its counters agree with the queued engine's meaning
    adj = small_hub_graph(np.random.default_rng(4))
    g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(adj.shape[0])], p=0.5,
                                   q=2.0, random_state=7, degree_cap=6, device="cpu")
    dg = g.get_device_graph()
    starts = torch.from_numpy(g._start_nodes(2))
    draws = engine.TrialDrawStream(g._seed(), 0, 2, g.device)
    with trace.job("pecanpy.walks"):
        _, eff, rounds = engine.generate_walks_amortized(
            dg, starts, draws, 12, 0.5, 2.0, False, return_rounds=True)
    rec = trace.last_job("pecanpy.walks")
    assert rec.counter("walk.hub_rounds") == rounds > 0
    assert rec.counter("walk.hub_lane_rounds") == rounds * starts.numel()
    # no lane hit the round cap: a lane wrote columns 2 .. eff - 1 in the rounds
    steps = rec.counter("walk.hub_steps")
    assert steps == int(np.maximum(eff.numpy().astype(np.int64) - 2, 0).sum()) > 0
    assert steps <= rec.counter("walk.hub_lane_rounds")


def test_every_port_span_name_has_the_prefix():
    names = []
    call = re.compile(r"trace\.(?:span|sync|job)\(f?\"([^\"]+)\"")
    for path in PKG.rglob("*.py"):
        names += call.findall(path.read_text())
    assert len(names) > 40
    assert all(n.startswith(trace.PREFIX) for n in names), names
