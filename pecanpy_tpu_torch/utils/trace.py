"""Spans and counters inside the port: one registry per process.

Two levels:

* **Always on.** ``span(name)`` adds three numbers to the totals of the
  job that is open: its count, its total nanoseconds, and its
  ``wait_ns``, the time of the ``sync`` spans nested inside it at any
  depth (a sync's own ``wait_ns`` is its whole time). ``count(name, n)``
  adds to the job's counters. A job (``job(name)``) is the top-level span
  of an entry call (``Base.embed``, ``Base.simulate_walks_device``, the
  layout build of ``Base.get_device_graph``); a job opened inside a job
  is a span of it, and ``jobs()`` returns the last ``MAX_JOBS`` finished
  ones. A span costs one clock pair and a dict update; outside a job it
  counts nowhere.
* **Enabled** (``enable()``; nothing enables it implicitly, a profiler
  that is running does not): each span is also appended to an in-memory
  log (``spans()``), at most ``MAX_SPANS`` records with a count of those
  dropped (``dropped()``), and entered as a
  ``torch.profiler.record_function`` range of the same name, so that a
  profile shows the port's spans beside its kernels. Disabled, the port
  emits no ``record_function`` range: a profiler that takes every device
  event for a kernel sees none of the port's names.

``sync(name)`` is a span of the sync kind. It marks a blocking
host-device synchronization: a device-to-host read (``.item()``,
``int(t)``, ``.tolist()``, ``.cpu()``) or a copy from pageable host memory
to the device, each of which waits for the device's queue to drain on a
CUDA device. Every sync adds one to its job's ``syncs`` counter. The
count is structural: a CPU run enters the same syncs as a run on the
card, where each of them blocks.

The log's timestamps are unix nanoseconds, the clock of the profiler's
events (``_KinetoEvent.start_ns()``), so a span lines up with the kernels
of the same trace. The clock is read after the range is entered and
before it is left, so a span's time leaves out the range's own cost.
Every name starts with ``pecanpy.``. The registry is kept by the thread
that runs the port's calls; the port's Python code runs on one.
"""
import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

import torch

PREFIX = "pecanpy."
SYNCS = "syncs"  # the counter every sync adds to
MAX_JOBS = 64
MAX_SPANS = 1 << 18

_clock = time.perf_counter_ns


class SpanTotals(NamedTuple):
    """One span name's totals in a job."""

    count: int
    total_ns: int
    wait_ns: int

    @property
    def dispatch_ns(self) -> int:
        """Time outside the syncs nested in the span."""
        return self.total_ns - self.wait_ns


class SpanRecord(NamedTuple):
    """One span of the enabled level's log: unix ns, the log index of the
    enclosing logged span (-1: none) and the job's id (-1: no job)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    job: int


@dataclasses.dataclass
class JobRecord:
    """One finished job: its totals by span name (its own name among
    them), integer counters, and counters kept as device tensors, which
    ``counter`` sums and reads when asked."""

    id: int
    name: str
    wall_ns: int
    profiled: bool
    spans: Dict[str, SpanTotals]
    counters: Dict[str, int]
    device_counters: Dict[str, List[torch.Tensor]]

    def counter(self, name: str) -> int:
        """The counter's value, device tensors summed and read."""
        return self.counters.get(name, 0) + sum(
            int(t.sum()) for t in self.device_counters.get(name, ()))

    def span(self, name: str) -> SpanTotals:
        return self.spans.get(name, SpanTotals(0, 0, 0))


class _OpenJob:
    __slots__ = ("id", "name", "profiled", "spans", "counters", "device_counters")

    def __init__(self, job_id: int, name: str, profiled: bool):
        self.id, self.name, self.profiled = job_id, name, profiled
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}
        self.device_counters: Dict[str, List[torch.Tensor]] = {}


class _Registry:
    def __init__(self):
        self.stack: list = []  # open frames: [name, t0, wait_ns, log index]
        self.job: Optional[_OpenJob] = None
        self.finished: collections.deque = collections.deque(maxlen=MAX_JOBS)
        self.next_id = 0
        self.enabled = False
        self.offset_ns = 0  # unix ns minus the span clock
        self.log: List[list] = []
        self.dropped = 0


_R = _Registry()


def _profiler_on() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


class _Span(contextlib.ContextDecorator):
    __slots__ = ("name", "is_sync", "frame", "range")

    def __init__(self, name: str, is_sync: bool = False):
        self.name, self.is_sync = name, is_sync
        self.range = None

    def _recreate_cm(self):
        # as a decorator, each call (recursive ones too) opens its own span
        return type(self)(self.name, self.is_sync)

    def __enter__(self):
        r = _R
        idx = -1
        if r.enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            if len(r.log) < MAX_SPANS:
                idx = len(r.log)
                parent = r.stack[-1][3] if r.stack else -1
                r.log.append([self.name, 0, 0, parent, r.job.id if r.job else -1])
            else:
                r.dropped += 1
        self.frame = frame = [self.name, 0, 0, idx]
        r.stack.append(frame)
        frame[1] = _clock()
        return self

    def _close(self) -> int:
        """Pop the span, add it up; returns its duration in ns."""
        t1 = _clock()
        r = _R
        frame, stack = self.frame, r.stack
        if stack and stack[-1] is frame:
            stack.pop()
        else:  # an inner span was left without its exit: drop it too
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is frame:
                    del stack[i:]
                    break
        d = t1 - frame[1]
        wait = d if self.is_sync else frame[2]
        if r.stack:
            r.stack[-1][2] += wait
        job = r.job
        if job is not None:
            tot = job.spans.get(self.name)
            if tot is None:
                job.spans[self.name] = [1, d, wait]
            else:
                tot[0] += 1
                tot[1] += d
                tot[2] += wait
            if self.is_sync:
                job.counters[SYNCS] = job.counters.get(SYNCS, 0) + 1
        if frame[3] >= 0:
            rec = r.log[frame[3]]
            rec[1], rec[2] = frame[1] + r.offset_ns, t1 + r.offset_ns
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return d

    def __exit__(self, *exc):
        self._close()
        return False


class _Job(_Span):
    __slots__ = ("outer",)

    def __enter__(self):
        r = _R
        self.outer = r.job is None
        if self.outer:
            r.job = _OpenJob(r.next_id, self.name, _profiler_on())
            r.next_id += 1
        return super().__enter__()

    def __exit__(self, *exc):
        d = self._close()
        if self.outer:
            r = _R
            job, r.job = r.job, None
            r.finished.append(JobRecord(
                job.id, job.name, d, job.profiled,
                {k: SpanTotals(*v) for k, v in job.spans.items()},
                dict(job.counters), {k: list(v) for k, v in job.device_counters.items()},
            ))
        return False


def span(name: str) -> _Span:
    """A span of ``name`` around the ``with`` block (or, as a decorator,
    around each call of the function)."""
    return _Span(name)


def sync(name: str) -> _Span:
    """A span around one blocking host-device synchronization."""
    return _Span(name, True)


def job(name: str) -> _Span:
    """The top-level span of an entry call (a ``with`` block, or a
    decorator around the entry function): opens a job record, or inside
    a job is a span of it. ``profiled`` is set when a ``torch.profiler``
    is running as the job starts."""
    return _Job(name)


def count(name: str, n=1):
    """Add ``n`` to the open job's counter ``name`` (nothing outside a
    job). A tensor ``n`` adds the sum of its elements: it is kept as it is
    and summed and read only when a reader asks (``JobRecord.counter``),
    so counting it never waits."""
    job_ = _R.job
    if job_ is None:
        return
    if isinstance(n, torch.Tensor):
        job_.device_counters.setdefault(name, []).append(n.detach())
    else:
        job_.counters[name] = job_.counters.get(name, 0) + int(n)


def jobs() -> List[JobRecord]:
    """The last ``MAX_JOBS`` finished jobs, oldest first."""
    return list(_R.finished)


def last_job(name: Optional[str] = None) -> Optional[JobRecord]:
    """The newest finished job (named ``name``, if given), or None."""
    for rec in reversed(_R.finished):
        if name is None or rec.name == name:
            return rec
    return None


def reset():
    """Forget every finished job and the span log."""
    _R.finished.clear()
    _R.log.clear()
    _R.dropped = 0


def enable():
    """Turn on the log and the ``record_function`` ranges."""
    _R.offset_ns = time.time_ns() - _clock()
    _R.enabled = True


def disable():
    _R.enabled = False


def is_enabled() -> bool:
    return _R.enabled


def spans() -> List[SpanRecord]:
    """The enabled level's log, in the order the spans opened (a span
    still open reads 0 for both times)."""
    return [SpanRecord(*rec) for rec in _R.log]


def dropped() -> int:
    """Spans left out of the log since ``reset`` (it was full)."""
    return _R.dropped

