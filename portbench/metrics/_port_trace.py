"""Shared reading of the port's own per-call records
(``pecanpy_tpu_torch/utils/trace.py``), for the ``program_span`` and
``program_counter`` metrics.

The port keeps a record of every entry call (a job) at a cost small enough
to leave on, so the harness turns nothing on: ``window_jobs`` selects the
traced window's jobs, the last ``len(ctx["calls"])`` records that ran
without a profiler (``profiled`` false), each of them named after the
cell's entry. The set-up's warm-up ran before them and the profiled call
after them (``profiled`` true), so both are left out. A port without the
registry, or records that do not match the window, give None, and so does
every reader of this directory that uses them.

The traced window's own spans (``harness/trace.py``) synchronize before
and after each walk chunk and each training buffer, outside the port's
spans: a sync of the port's that falls on such an edge waits on an empty
queue there, and its count is exact all the same.
"""

JOB_OF_ENTRY = {"embed": "pecanpy.embed", "walks": "pecanpy.walks"}


def window_jobs(ctx):
    """The traced window's job records, oldest first, or None."""
    try:
        from pecanpy_tpu_torch.utils import trace
    except ImportError:
        return None
    n = len(ctx["calls"])
    name = JOB_OF_ENTRY.get(ctx["traffic"]["entry"])
    records = [r for r in trace.jobs() if not r.profiled]
    if n == 0 or len(records) < n:
        return None
    records = records[-n:]
    if any(r.name != name for r in records):
        return None
    return records


def span_totals(records, name):
    """(count, total ns, wait ns) of span ``name`` summed over ``records``."""
    parts = [r.spans.get(name) for r in records]
    parts = [p for p in parts if p is not None]
    return (sum(p.count for p in parts), sum(p.total_ns for p in parts),
            sum(p.wait_ns for p in parts))


def counter(records, name):
    """Counter ``name`` summed over ``records``."""
    return sum(r.counter(name) for r in records)
