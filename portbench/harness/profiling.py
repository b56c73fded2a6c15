"""One call of the cell's entry under ``torch.profiler``, reduced.

Busy time is the union of the intervals in which a kernel ran on the
device; the window is the call's host-clock time (it ends with a
synchronize). Idle gaps are the stretches between kernels, each put down
to the benchmark span the host was in (``portbench.*`` record_function
ranges, else "host"). The arithmetic of the idle share (1 - busy / host
window) is ``profile_port.py``'s.
"""
import bisect
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10


def _device_events(prof):
    """[((start us, end us), name, on the device)] of a finished profile,
    from the raw kineto events, which skips building the profiler's
    FunctionEvent tree over the hundreds of thousands of events of an
    embed call."""
    raw = prof.profiler.kineto_results.events()
    return [((e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3), e.name(),
             e.device_type() == DeviceType.CUDA) for e in raw]


def profiled_call(fn, device):
    """Run ``fn()`` once under the profiler. Returns a dict: ``busy_s``,
    ``window_s``, ``kernels`` {name: (seconds, launches)},
    ``device_ops`` and ``idle_gaps`` ([[name, seconds]], at most 10),
    ``reduce_s`` (the seconds this reduction took)."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = _device_events(prof)
    # device events, without the ranges the profiler mirrors onto the
    # device for the benchmark's own record_function spans
    kernels = sorted((r, n) for r, n, dev in events if dev and not n.startswith("portbench."))
    spans = sorted(r + (n,) for r, n, dev in events if not dev and n.startswith("portbench."))
    by_name = defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    gaps = defaultdict(float)
    end = None
    span_starts = [s[0] for s in spans]
    for (lo, hi), name in kernels:
        by_name[name][0] += (hi - lo) * 1e-6
        by_name[name][1] += 1
        if end is None:
            busy_us += hi - lo
            end = hi
            continue
        if lo > end:
            mid = 0.5 * (lo + end)
            k = bisect.bisect_right(span_starts, mid) - 1
            label = spans[k][2] if k >= 0 and spans[k][1] >= mid else "host"
            gaps[label] += (lo - end) * 1e-6
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    ops = sorted(((n, s) for n, (s, _) in by_name.items()), key=lambda x: -x[1])[:TOP]
    return dict(
        result=result,
        busy_s=busy_us * 1e-6,
        window_s=window_s,
        kernels={n: tuple(v) for n, v in by_name.items()},
        device_ops=[[n[:120], s] for n, s in ops],
        idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:TOP]],
        reduce_s=time.perf_counter() - t1,
    )


def kernel_seconds(kernels, tag: str):
    """(device seconds, launches) summed over kernels whose name holds ``tag``."""
    s, n = 0.0, 0
    for name, (sec, count) in kernels.items():
        if tag in name:
            s, n = s + sec, n + count
    return s, n
