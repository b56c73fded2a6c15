"""Spans and counters taken from the benchmark's side of the port's calls.

The port records nothing a reader could use beyond its launch counters
(``apply_sorted_stream.launches``, ``trial_propose.launches``,
``trial_accept.launches``), so the traced run wraps the port's functions
from here, for its own duration only:

* ``Base._walk_chunks`` of the mode instance: host time of each walk
  chunk the caller pulls, with a synchronize on both sides;
* ``sgns._run_buffer``: host time and chunk-steps of each buffer of the
  training pass, synchronized the same way;
* ``apply.apply_sorted_stream`` (kernel 2.1) and ``trialkernel.
  trial_propose`` / ``trial_accept``: each launch's stream shape, kept
  as device scalars, so no launch waits for the host.

Spans that synchronize change the overlap of host and device, so the
window whose numbers are end-to-end metrics runs without any of this,
and the profiled call runs with the shape recorders only.
"""
import contextlib
import time

import torch
from torch.profiler import record_function

from harness.entries import sync


class Recorder:
    """What one traced stretch of calls did, layer by layer."""

    def __init__(self):
        self.walk_s = 0.0
        self.walk_chunks = 0
        self.train_s = 0.0
        self.train_steps = 0
        self.applier = []  # (rows, touched rows as a device scalar, dim, element bytes)
        self.trials = []  # ("propose" | "accept", lanes, trials)

    def applier_streams(self):
        """[(rows, touched, dim, element bytes)] with the touched counts read."""
        return [(r, int(t), d, e) for r, t, d, e in self.applier]


@contextlib.contextmanager
def patched(patches):
    """Set (object, attribute, value) for the block, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def _counted(module, name, record):
    """A wrapper of ``module.name`` that records each call's shapes and
    carries the launch counter the wrapped body increments by name."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        record(*args, **kwargs)
        return original(*args, **kwargs)

    wrapper.launches = original.launches

    def restore():
        original.launches = wrapper.launches

    return wrapper, restore


@contextlib.contextmanager
def spans(mode, rec: Recorder, timed: bool):
    """Record ``rec`` around the port's layers while the block runs.
    ``timed``: also take the synchronized host-clock spans."""
    from pecanpy_tpu_torch.models import sgns
    from pecanpy_tpu_torch.ops import apply, trialkernel

    device = mode.device
    walk_chunks = mode._walk_chunks
    run_buffer = sgns._run_buffer

    def chunks(num_walks, walk_length):
        it = walk_chunks(num_walks, walk_length)
        while True:
            if timed:
                sync(device)
            t0 = time.perf_counter()
            with record_function("portbench.walk_chunk"):
                item = next(it, None)
            if item is None:
                return
            if timed:
                sync(device)
                rec.walk_s += time.perf_counter() - t0
            rec.walk_chunks += 1
            yield item

    def buffer(*args, **kwargs):
        if timed:
            sync(device)
        t0 = time.perf_counter()
        with record_function("portbench.sgns_buffer"):
            steps, tokens = run_buffer(*args, **kwargs)
        if timed:
            sync(device)
            rec.train_s += time.perf_counter() - t0
        rec.train_steps += steps
        return steps, tokens

    def on_apply(table, ids_s, upd_s, seed=0):
        r = int(ids_s.shape[0])
        touched = (ids_s[1:] != ids_s[:-1]).sum() + 1 if r else torch.zeros((), device=table.device)
        rec.applier.append((r, touched, int(table.shape[1]), table.element_size()))

    def on_propose(dg, draws, prev, cur, *args, **kwargs):
        rec.trials.append(("propose", int(cur.shape[0]), int(draws.kk.shape[0])))

    def on_accept(dg, draws, x, wx, prev, *args, **kwargs):
        rec.trials.append(("accept", int(prev.shape[0]), int(draws.kk.shape[0])))

    apply_w, apply_r = _counted(apply, "apply_sorted_stream", on_apply)
    prop_w, prop_r = _counted(trialkernel, "trial_propose", on_propose)
    acc_w, acc_r = _counted(trialkernel, "trial_accept", on_accept)
    try:
        with patched([(mode, "_walk_chunks", chunks), (sgns, "_run_buffer", buffer),
                      (apply, "apply_sorted_stream", apply_w),
                      (trialkernel, "trial_propose", prop_w),
                      (trialkernel, "trial_accept", acc_w)]):
            yield rec
    finally:
        apply_r()
        prop_r()
        acc_r()
        if "_walk_chunks" in vars(mode):
            del mode._walk_chunks
