"""precomp_build_s: seconds of PreComp's per-edge table build: the wall
time of the port's job ``pecanpy.precomp``
(``models/modes.py:PreComp.preprocess_transition_probs``, which ends on a
synchronize), opened by the set-up's warm-up, the first walk chunk. The
newest such job of the process (``trace.last_job``); None where the port
has no such job, as before it traced the build."""


def read(ctx):
    try:
        from pecanpy_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = trace.last_job("pecanpy.precomp")
    if rec is None:
        return None
    return 1e-9 * rec.wall_ns
