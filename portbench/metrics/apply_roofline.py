"""apply_roofline: kernel 2.1's share of its roofline (``csrc/apply.cu``
via ``ops/apply.py:apply_sorted_stream``), in the profiled call.

Least time of each launch: its bytes (``yardstick.applier_bytes``: ids
and f32 payload read once, each touched row read and written once) at
3.35 TB/s; its FLOPs (one add per payload element) are far below, so
bytes bound it. Summed over the launches, over the device time of the
kernel's two passes (``apply_sorted_kernel``, ``apply_long_kernel``).
"""
from harness import profiling, yardstick


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    streams = prof["recorder"].applier_streams()
    dev_s = sum(profiling.kernel_seconds(prof["kernels"], tag)[0]
                for tag in ("apply_sorted_kernel", "apply_long_kernel"))
    if not streams or dev_s <= 0:
        return None
    least = sum(yardstick.least_time(r * d, yardstick.applier_bytes(r, t, d, e),
                                     yardstick.H100_PEAKS["fp32_flops"])[0]
                for r, t, d, e in streams)
    return 100.0 * least / dev_s
