"""walk_step_mfu.walks: the whole walk call's share of the H100's peak, in
%: its least time counted from shapes (``yardstick.walk_call_least``: the
walk matrix written once and a sector of the current row read a step, at
3.35 TB/s) times the calls of the traced window, over the window's host
time. It bounds any gain a walk engine or kernel can claim, also after a
later PR takes a kernel whose roofline is measured off the path."""
from harness import yardstick


def read(ctx):
    calls = ctx["calls"]
    if not calls or ctx["window_s"] <= 0:
        return None
    cfg = ctx["config"]
    walks = ctx["mode"].num_nodes * cfg["num_walks"]
    least = yardstick.walk_call_least(walks, cfg["walk_length"])[0]
    return 100.0 * least * len(calls) / ctx["window_s"]
