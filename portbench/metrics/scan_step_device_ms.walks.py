"""scan_step_device_ms.walks: device milliseconds of one step of the scan
walk engine (``models/engine.py:generate_walks``): the profiled call's
device busy time over its chunks x (walk_length - 1) second-order steps."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["recorder"].walk_chunks == 0:
        return None
    steps = prof["recorder"].walk_chunks * (ctx["config"]["walk_length"] - 1)
    return 1e3 * prof["busy_s"] / steps
