"""walk_s_per_call.embed: seconds of walk generation in one ``embed`` call:
the synchronized host time of every chunk the trainer pulled from
``Base._walk_chunks`` in the traced window, over the calls."""


def read(ctx):
    rec = ctx["recorder"]
    if rec.walk_chunks == 0 or not ctx["calls"]:
        return None
    return rec.walk_s / len(ctx["calls"])
