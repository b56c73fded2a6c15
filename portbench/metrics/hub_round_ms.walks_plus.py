"""hub_round_ms.walks_plus: milliseconds of one round of the queued hub
engine (``models/engine.py:generate_walks_queued``) on node2vec+'s route,
whose trial blocks are the plain ``rejection._trial_block`` and launch no
trial kernel: the traced walk window's host time over the port's counter
``walk.hub_rounds`` in the window's jobs (``_port_trace.window_jobs``).

What the traced window does to it: the harness synchronizes before and
after each walk chunk, as for ``hub_round_ms.walks``; the rounds are the
untraced call's.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    rounds = _port.counter(records, "walk.hub_rounds")
    if rounds == 0:
        return None
    return 1e3 * ctx["window_s"] / rounds
