"""The six readers of the port's own spans and counters.

Each runs a whole CPU run of a tiny cell (1,500 nodes, as
``test_portbench_imports.py`` does) and must give a number for every one
of them that the cell lists: ``uniform1m.embed`` for the SGNS and embed
readers, ``powerlaw1m.walks`` (hubs even at this size) for the hub and
walks readers. A port without the registry gives None from every reader,
and raises nothing: the parent of the change that brings it has none.
"""
import builtins
import math

import pytest

import test_portbench_cells
from harness import cells, runner

NEW = {
    "uniform1m.embed": ["sgns_dispatch_ms_per_chunk_step", "sgns_wait_ms_per_chunk_step",
                        "host_syncs_per_call.embed"],
    "powerlaw1m.walks": ["hub_dispatch_ms_per_round.walks", "hub_lane_yield.walks",
                         "host_syncs_per_call.walks"],
}


@pytest.fixture(scope="module")
def runs():
    from pecanpy_tpu_torch.models import base

    threshold = base.Base.STREAMING_TOKEN_THRESHOLD
    base.Base.STREAMING_TOKEN_THRESHOLD = 0  # the streaming trainer, as at full size
    out = {}
    try:
        for name in NEW:
            cell = cells.resolve(name)
            cell.config["graph"]["params"]["num_nodes"] = 1500
            result, diag = runner.run_cell(cell, 2**31 + 7, 0.01, True, "cpu", 0.0)
            out[name] = (cell, result, diag)
    finally:
        base.Base.STREAMING_TOKEN_THRESHOLD = threshold
    return out


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_give_numbers_on_a_cpu_run(runs, name):
    cell, result, diag = runs[name]
    assert result["correct"] and result["metrics"] == {}  # a CPU run measures nothing
    listed = {m.name for m in cell.per_layer}
    assert set(NEW[name]) <= listed
    for metric in NEW[name]:
        value = diag["cpu_numbers"][metric]["value"]
        assert math.isfinite(value) and value >= 0, (metric, value)
    numbers = {k: v["value"] for k, v in diag["cpu_numbers"].items()}
    if name == "powerlaw1m.walks":
        assert 0 < numbers["hub_lane_yield.walks"] <= 100
        assert numbers["hub_dispatch_ms_per_round.walks"] > 0
        # a chunk's start upload, its queue cursor and a read every 16 rounds
        assert numbers["host_syncs_per_call.walks"] >= 3
    else:
        assert numbers["sgns_dispatch_ms_per_chunk_step"] > 0
        # the CPU's scatter path and a small chunk make no sync in a step
        assert numbers["sgns_wait_ms_per_chunk_step"] == 0
        assert numbers["host_syncs_per_call.embed"] >= 6


def test_readers_give_none_without_the_registry(runs, monkeypatch):
    cell, _, diag = runs["powerlaw1m.walks"]
    ctx = dict(cell=cell, config=cell.config, traffic=cell.traffic, calls=[1.0],
               profile=None)
    real_import = builtins.__import__

    def no_trace(name, *args, **kwargs):
        if name.startswith("pecanpy_tpu_torch.utils") and "trace" in str(args[2:3]):
            raise ImportError("no registry")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    for metrics in NEW.values():
        for metric in metrics:
            assert cell.metric_reader(metric).read(ctx) is None, metric


def test_readers_give_none_on_records_of_another_entry(runs):
    cell, _, _ = runs["powerlaw1m.walks"]
    embed = cells.resolve("uniform1m.embed")
    # the newest records are the walks cell's: an embed window matches none
    ctx = dict(cell=embed, config=embed.config, traffic=embed.traffic, calls=[1.0],
               profile=None)
    for metric in NEW["uniform1m.embed"]:
        assert embed.metric_reader(metric).read(ctx) is None, metric


def test_manifest_still_keeps_the_contract():
    test_portbench_cells.test_manifest_keys_and_names()
