"""sgns_step_mfu: the whole SGNS chunk-step's share of the H100's peak.

For each chunk-step of the traced window, its least time counted from
shapes (``harness.yardstick.sgns_step_least``: FLOPs of its dot products
and gradients at the float32 peak, or its bytes, walk tokens and the rows
its two table updates name, read and written once, at 3.35 TB/s; the
larger), summed over the chunk-steps, over the training pass's host time.
The rows come from the two applier launches of each step. The share
stays a bound for the step after a later PR fuses or removes a kernel.
"""
from harness import yardstick
from reference import sgns_steps


def read(ctx):
    rec = ctx["recorder"]
    streams = rec.applier_streams()
    if rec.train_steps == 0 or len(streams) != 2 * rec.train_steps or rec.train_s <= 0:
        return None
    cfg = ctx["config"]
    cols = cfg["walk_length"] + 1
    h = sgns_steps.Hyper(dim=cfg["dim"], window=cfg["window_size"])
    walks = sgns_steps.batch_walks(h, ctx["mode"].num_nodes, cols)
    least = 0.0
    for k in range(rec.train_steps):
        (_, t_in, dim, elem), (_, t_out, _, _) = streams[2 * k], streams[2 * k + 1]
        least += yardstick.sgns_step_least(walks, cols, h.window, h.negative, dim,
                                           t_in + t_out, elem)[0]
    return 100.0 * least / rec.train_s
