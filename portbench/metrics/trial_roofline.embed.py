"""trial_roofline.embed: the trial kernels' share of their roofline in the
profiled call of a embed cell (see ``_trial_roofline.share``)."""

from harness import cells

_shared = cells.load_module(cells.BENCH_DIR / "metrics" / "_trial_roofline.py")


def read(ctx):
    return _shared.share(ctx)
