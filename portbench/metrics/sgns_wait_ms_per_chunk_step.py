"""sgns_wait_ms_per_chunk_step: host milliseconds one SGNS chunk-step
spends blocked in syncs: the ``wait_ns`` of the port's span
``pecanpy.sgns.chunk_step`` (the time of the ``sync`` spans nested in it)
over its count, in the traced window's jobs (``_port_trace.window_jobs``).
The chunk-step holds no sync on the port's path, so the metric reads 0
unless a change brings one into the step.

What the traced window does to it: the harness synchronizes before and
after each training buffer, so a sync in a buffer's first chunk-step
would wait on an empty queue; every later step's wait is the untraced one.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    count, _, wait_ns = _port.span_totals(records, "pecanpy.sgns.chunk_step")
    if count == 0:
        return None
    return 1e-6 * wait_ns / count
