"""precomp_walk_roofline: the PreComp walk call's share of its roofline,
in %: the least bytes of the profiled call (``least_bytes``) at the
H100's 3.35 TB/s over the call's device busy time.

The least bytes come from the call's shapes, whatever implements its
step: per nominal second-order lane-step (walks x (walk_length - 1)),
one 32-byte sector of the edge's table row (the step's distribution)
and one of the next node's row (its neighbour's id); and the int32 walk
matrix written once. Its FLOPs, a compare-reduce a step, are far below.
"""
from harness import yardstick


def least_bytes(walks: int, walk_length: int) -> int:
    second_order = walks * (walk_length - 1)
    return second_order * 2 * yardstick.SECTOR + walks * (walk_length + 1) * 4


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["busy_s"] <= 0:
        return None
    cfg = ctx["config"]
    walks = ctx["mode"].num_nodes * cfg["num_walks"]
    least_s = least_bytes(walks, cfg["walk_length"]) / yardstick.H100_PEAKS["hbm_bytes_per_s"]
    return 100.0 * least_s / prof["busy_s"]
