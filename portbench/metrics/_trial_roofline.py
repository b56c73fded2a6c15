"""Shared arithmetic of the trial kernels' roofline readers."""
from harness import profiling, yardstick


def share(ctx):
    """The trial kernels' (``csrc/trial.cu``) least time over their device
    time in the profiled call, in %, or None where they did not run.
    Least bytes per launch: ``yardstick.trial_propose_bytes`` /
    ``trial_accept_bytes``, a lower bound of ``chip_smoke.py:trial_bytes``
    (the lanes' own traffic and two sectors a lane); bytes bound them."""
    prof = ctx["profile"]
    if prof is None:
        return None
    launches = prof["recorder"].trials
    dev_s = sum(profiling.kernel_seconds(prof["kernels"], tag)[0]
                for tag in ("trial_propose_kernel", "trial_accept_kernel"))
    if not launches or dev_s <= 0:
        return None
    nbytes = sum(yardstick.trial_propose_bytes(b, t) if kind == "propose"
                 else yardstick.trial_accept_bytes(b, t) for kind, b, t in launches)
    return 100.0 * nbytes / yardstick.H100_PEAKS["hbm_bytes_per_s"] / dev_s
