"""sgns_graph_step_share: the share of SGNS chunk-steps whose body (the
update streams, ``models/sgns.py:make_step_body``) ran as a replay of a
captured CUDA graph, in %: 100 x the port's counter ``sgns.graph_replays``
over the count of its span ``pecanpy.sgns.chunk_step``, in the traced
window's jobs (``_port_trace.window_jobs``).

Each embed call builds its own step, whose first chunk-step runs eagerly
and whose second captures the graph, so a call of C chunk-steps reads
100 x (C - 1) / C. A port without the counter reads 0; one without the
registry, None.
"""
from harness import cells

_port = cells.load_module(cells.BENCH_DIR / "metrics" / "_port_trace.py")


def read(ctx):
    records = _port.window_jobs(ctx)
    if records is None:
        return None
    count, _, _ = _port.span_totals(records, "pecanpy.sgns.chunk_step")
    if count == 0:
        return None
    return 100.0 * _port.counter(records, "sgns.graph_replays") / count
