"""hub_dispatch_ms_per_round.walks: host milliseconds of one round of the
queued hub engine outside its syncs: the total time of the port's span
``pecanpy.walk.hub_block`` (``models/engine.py:generate_walks_queued``: a
block of rounds, its flush and claim, and the pending count's read) less
its ``wait_ns`` (that read), over the counter ``walk.hub_rounds``, in the
traced window's jobs (``_port_trace.window_jobs``).

What the traced window does to it: the harness synchronizes before and
after each walk chunk, outside the blocks; a block's dispatch does not
wait on the device, so the reading is the untraced one.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    count, total_ns, wait_ns = _port.span_totals(records, "pecanpy.walk.hub_block")
    rounds = _port.counter(records, "walk.hub_rounds")
    if count == 0 or rounds == 0:
        return None
    return 1e-6 * (total_ns - wait_ns) / rounds
