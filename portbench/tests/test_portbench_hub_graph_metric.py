"""The reader of ``hub_graph_round_share.walks``: the share of the queued
hub engine's rounds that replayed a captured CUDA graph.

A CPU run of a tiny ``powerlaw1m.walks_plus`` (1,500 nodes, hubs even at
this size) walks op by op, so the reader gives 0 there. Job records made
through the port's registry give the replayed rounds over all rounds;
records of a port that does not count replayed rounds (the engine before
the graph), of another entry, or without hub rounds, and a port without
the registry, give None and raise nothing.
"""
import builtins
import math

import pytest

from harness import cells, runner

METRIC = "hub_graph_round_share.walks"
CELL = "powerlaw1m.walks_plus"


@pytest.fixture(scope="module")
def run():
    cell = cells.resolve(CELL)
    cell.config["graph"]["params"]["num_nodes"] = 1500
    result, diag = runner.run_cell(cell, 2**31 + 13, 0.01, True, "cpu", 0.0)
    return cell, result, diag


def _ctx(cell, n_calls):
    return dict(cell=cell, config=cell.config, traffic=cell.traffic,
                calls=[1.0] * n_calls, profile=None)


def test_reader_gives_zero_on_a_cpu_run(run):
    cell, result, diag = run
    assert result["correct"] and result["metrics"] == {}  # a CPU run measures nothing
    assert METRIC in {m.name for m in cell.per_layer}
    value = diag["cpu_numbers"][METRIC]["value"]
    # CPU tables walk op by op: no round replays a graph
    assert math.isfinite(value) and value == 0


def test_listed_for_both_power_law_walk_cells():
    for name in ("powerlaw1m.walks_plus", "powerlaw1m.walks"):
        assert METRIC in {m.name for m in cells.resolve(name).per_layer}


@pytest.mark.parametrize("rounds,replayed", [(64, 48), (32, 32), (16, 0)])
def test_reader_gives_replayed_over_all_rounds(rounds, replayed):
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)

    @trace.job("pecanpy.walks")
    def call():
        trace.count("walk.hub_rounds", rounds)
        trace.count("walk.hub_graph_rounds", replayed)

    call()
    call()
    value = cell.metric_reader(METRIC).read(_ctx(cell, 2))
    assert value == pytest.approx(100.0 * replayed / rounds)


def test_reader_gives_none_where_no_round_is_counted_as_replayed_or_not():
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)
    trace.job("pecanpy.walks")(lambda: trace.count("walk.hub_rounds", 16))()
    assert cell.metric_reader(METRIC).read(_ctx(cell, 1)) is None


def test_reader_gives_none_without_hub_rounds():
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)
    trace.job("pecanpy.walks")(lambda: trace.count("walk.hub_graph_rounds", 0))()
    assert cell.metric_reader(METRIC).read(_ctx(cell, 1)) is None


def test_reader_gives_none_on_records_of_another_entry():
    from pecanpy_tpu_torch.utils import trace

    cell = cells.resolve(CELL)
    trace.job("pecanpy.embed")(lambda: None)()
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
