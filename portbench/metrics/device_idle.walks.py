"""device_idle.walks: the device's idle share in a walks cell, in %, with
``profile_port.py``'s arithmetic: 1 - the summed kernel time of one call
under the profiler (busy: the union of its kernel intervals) over the
host-clock time of a call without it (the mean call of the traced
window, whose spans synchronize only at chunk and buffer boundaries).
The profiler's own host cost stretches a host-bound call by up to 2.5x,
so the profiled call's own window would read the idle share high."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not ctx["calls"]:
        return None
    host_s = sum(ctx["calls"]) / len(ctx["calls"])
    return 100.0 * (1.0 - prof["busy_s"] / host_s)
