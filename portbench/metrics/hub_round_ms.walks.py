"""hub_round_ms.walks: milliseconds of one round of the queued hub engine
(``models/engine.py:generate_walks_queued``): the traced walk window's
host time over the ``trial_propose`` launches in it (one a round)."""


def read(ctx):
    rounds = sum(1 for kind, _, _ in ctx["recorder"].trials if kind == "propose")
    if rounds == 0:
        return None
    return 1e3 * ctx["window_s"] / rounds
