"""hub_lane_yield.walks: the share of the queued hub engine's lane-rounds
that wrote a walk step, in %: 100 x the counter ``walk.hub_steps`` (every
column a walk wrote past its start, a device scalar of one reduction a
chunk) over ``walk.hub_lane_rounds`` (rounds x lanes), in the traced
window's jobs (``_port_trace.window_jobs``). A lane-round writes nothing
when its trial block rejects, or when the lane has finished its walk and
waits for the block's flush, or for no walk at the queue's end.

What the traced window does to it: nothing; the counts are the walks'.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    lane_rounds = _port.counter(records, "walk.hub_lane_rounds")
    if lane_rounds == 0:
        return None
    return 100.0 * _port.counter(records, "walk.hub_steps") / lane_rounds
