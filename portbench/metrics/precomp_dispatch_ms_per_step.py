"""precomp_dispatch_ms_per_step: host milliseconds of one second-order
step of PreComp's walk outside the syncs: the total time of the port's
span ``pecanpy.walk.chunk`` (``models/base.py:Base._walk_chunks``: a
chunk's start upload, uniforms, first step, its second-order steps and
the stack of its columns) less its ``wait_ns`` (the start upload), over
the counter ``walk.precomp_steps`` (one a second-order step of a chunk,
``models/modes.py:PreComp.make_step_fns``), in the traced window's jobs
(``_port_trace.window_jobs``). Set beside the device's time a step, it
says whether the host's dispatch or the card sets the walk's pace. None
where the port does not count PreComp's steps.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    count, total_ns, wait_ns = _port.span_totals(records, "pecanpy.walk.chunk")
    steps = _port.counter(records, "walk.precomp_steps")
    if count == 0 or steps == 0:
        return None
    return 1e-6 * (total_ns - wait_ns) / steps
