"""The reader of ``sgns_graph_step_share``: the share of SGNS chunk-steps
whose body replayed a captured CUDA graph.

A CPU run of a tiny ``uniform1m.embed`` (1,500 nodes, as
``test_portbench_trace_metrics.py`` runs it) trains op by op, so the
reader gives 0 there. Job records made through the port's registry give
the share of replays over chunk-steps; a port without the registry, and
records of another entry, give None and raise nothing.
"""
import builtins
import math

import pytest

from harness import cells, runner

METRIC = "sgns_graph_step_share"
CELL = "uniform1m.embed"


@pytest.fixture(scope="module")
def run():
    from pecanpy_tpu_torch.models import base

    threshold = base.Base.STREAMING_TOKEN_THRESHOLD
    base.Base.STREAMING_TOKEN_THRESHOLD = 0  # the streaming trainer, as at full size
    try:
        cell = cells.resolve(CELL)
        cell.config["graph"]["params"]["num_nodes"] = 1500
        result, diag = runner.run_cell(cell, 2**31 + 11, 0.01, True, "cpu", 0.0)
    finally:
        base.Base.STREAMING_TOKEN_THRESHOLD = threshold
    return cell, result, diag


def _ctx(cell, n_calls):
    return dict(cell=cell, config=cell.config, traffic=cell.traffic,
                calls=[1.0] * n_calls, profile=None)


def test_reader_gives_zero_on_a_cpu_run(run):
    cell, result, diag = run
    assert result["correct"] and result["metrics"] == {}  # a CPU run measures nothing
    assert METRIC in {m.name for m in cell.per_layer}
    value = diag["cpu_numbers"][METRIC]["value"]
    # CPU tables train op by op: no chunk-step replays a graph
    assert math.isfinite(value) and value == 0


@pytest.mark.parametrize("steps,replays", [(5, 4), (3, 0), (1, 0)])
def test_reader_gives_replays_over_chunk_steps(steps, replays):
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)

    @trace.job("pecanpy.embed")
    def call():
        for _ in range(steps):
            with trace.span("pecanpy.sgns.chunk_step"):
                pass
        trace.count("sgns.graph_replays", replays)

    call()
    call()
    value = cell.metric_reader(METRIC).read(_ctx(cell, 2))
    assert value == pytest.approx(100.0 * replays / steps)


def test_reader_gives_none_without_chunk_steps():
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)
    trace.job("pecanpy.embed")(lambda: None)()
    assert cell.metric_reader(METRIC).read(_ctx(cell, 1)) is None


def test_reader_gives_none_on_records_of_another_entry():
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)
    trace.job("pecanpy.walks")(lambda: None)()
    assert cell.metric_reader(METRIC).read(_ctx(cell, 1)) is None


def test_reader_gives_none_without_the_registry(monkeypatch):
    cell = cells.resolve(CELL)
    real_import = builtins.__import__

    def no_trace(name, *args, **kwargs):
        if name.startswith("pecanpy_tpu_torch.utils") and "trace" in str(args[2:3]):
            raise ImportError("no registry")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert cell.metric_reader(METRIC).read(_ctx(cell, 1)) is None
