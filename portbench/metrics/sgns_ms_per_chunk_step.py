"""sgns_ms_per_chunk_step: milliseconds of one SGNS chunk-step: the
synchronized host time of the training pass (every ``sgns._run_buffer``)
in the traced window over the chunk-steps it ran."""


def read(ctx):
    rec = ctx["recorder"]
    if rec.train_steps == 0:
        return None
    return 1e3 * rec.train_s / rec.train_steps
