"""sgns_dispatch_ms_per_chunk_step: host milliseconds of one SGNS
chunk-step outside its syncs: the total time of the port's span
``pecanpy.sgns.chunk_step`` (``models/sgns.py:_run_buffer``: the step's
draws, its body and both table passes) less its ``wait_ns`` (the syncs
nested in it), over its count, in the traced window's jobs
(``_port_trace.window_jobs``).

What the traced window does to it: the harness synchronizes before and
after each training buffer, so the first chunk-step of a buffer finds an
empty queue; a step's dispatch does not wait on the device, so the
reading is the untraced one.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    count, total_ns, wait_ns = _port.span_totals(records, "pecanpy.sgns.chunk_step")
    if count == 0:
        return None
    return 1e-6 * (total_ns - wait_ns) / count
