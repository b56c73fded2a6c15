"""host_syncs_per_call.walks: blocking host-device synchronizations in one
walks call: the port's counter ``syncs`` (one for every ``sync`` span:
each read of a device value on the host and each copy from pageable host
memory to the device) summed over the traced window's jobs
(``_port_trace.window_jobs``) over their number.

What the traced window does to it: the harness's own synchronizations
around walk chunks and training buffers are not the port's and are not
counted; the count is the untraced call's.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    return _port.counter(records, "syncs") / len(records)
