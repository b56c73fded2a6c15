"""hub_graph_round_share.walks: the share of the queued hub engine's rounds
that ran as a replay of a captured CUDA graph, in %: 100 x the port's
counter ``walk.hub_graph_rounds`` over ``walk.hub_rounds``, in the traced
window's jobs (``_port_trace.window_jobs``).

The engine (``models/engine.py:generate_walks_queued``) captures a block
of rounds once per graph and shape in a process, on node2vec+'s route
(the plain trial block) on the card, and replays it from then on; the
set-up's warm-up chunk runs the first block eagerly and the capture, so
the window reads 100 there. node2vec's route (the trial kernels) stays
eager and reads 0. A port whose engine does not count the replayed
rounds (every call counts them, 0 included), one without the registry,
and a window without hub rounds give None.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    rounds = _port.counter(records, "walk.hub_rounds")
    if rounds == 0 or not any("walk.hub_graph_rounds" in r.counters for r in records):
        return None
    return 100.0 * _port.counter(records, "walk.hub_graph_rounds") / rounds
