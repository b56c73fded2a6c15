"""Peaks of the card and the least work of each measured piece.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit): the card's power limit is printed beside every run.
A roofline share is the least time the chip could take (the larger of
operations over the peak and bytes over the memory bandwidth) over the
measured time. Bytes count each input byte read once and each output
byte written once.
"""
H100_PEAKS = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
SECTOR = 32  # bytes a gather moves at the least


def least_time(flops: float, nbytes: float, flop_peak: float):
    """(least seconds, "flops" or "bytes": the term that bounds it)."""
    t_flops = flops / flop_peak
    t_bytes = nbytes / H100_PEAKS["hbm_bytes_per_s"]
    return (t_flops, "flops") if t_flops > t_bytes else (t_bytes, "bytes")


def applier_bytes(rows: int, touched: int, dim: int, table_elem: int) -> int:
    """Kernel 2.1 (``csrc/apply.cu``) on a sorted stream of ``rows``
    entries naming ``touched`` distinct table rows: the int32 ids and the
    f32 payload read once, each touched row read and written once (copied
    from ``chip_smoke.py``'s applier bound)."""
    return rows * 4 + rows * dim * 4 + 2 * touched * dim * table_elem


def trial_propose_bytes(lanes: int, trials: int) -> int:
    """A lower bound of the bytes ``trial_propose`` moves: of the terms of
    ``chip_smoke.py:trial_bytes``, those that do not depend on the data:
    each lane's id, draws and outputs, the sector of its degree and the
    head sector of its cur row."""
    return lanes * (4 + trials * 16 + 12 + trials * 8) + 2 * SECTOR * lanes


def trial_accept_bytes(lanes: int, trials: int) -> int:
    """A lower bound of the bytes ``trial_accept`` moves: each lane's
    prev id, the proposals it reads, its outputs, the sector of its degree
    and at least one sector of its prev row (``chip_smoke.py:trial_bytes``'s
    terms that do not depend on the data)."""
    return lanes * (trials * 12 + 4 + 9) + 2 * SECTOR * lanes


def window_pairs(walk_cols: int, window: int) -> float:
    """Expected (centre, context) pairs of one full walk of ``walk_cols``
    tokens with every token kept, under reduced windows uniform in
    1..window: centre i reaches offset d with probability (window-d+1)/window."""
    total = 0.0
    for i in range(walk_cols):
        for d in range(1, window + 1):
            reach = (window - d + 1) / window
            total += reach * ((i - d >= 0) + (i + d < walk_cols))
    return total


def sgns_step_least(walks: int, walk_cols: int, window: int, negative: int, dim: int,
                    touched_rows: int, table_elem: int):
    """Least (seconds, bound) of one SGNS chunk-step, counted from its
    shapes: per (centre, context) pair a score, a centre and a context
    gradient (3 dot products of ``dim``: 6 * dim FLOPs); per token and
    negative slot the same three; in float32 (the step computes in f32).
    Bytes: the int32 walk tokens, and ``touched_rows`` table rows (the
    rows the step's two table updates name) read and written once."""
    tokens = walks * walk_cols
    pairs = walks * window_pairs(walk_cols, window)
    flops = 6.0 * dim * (pairs + tokens * negative)
    nbytes = tokens * 4 + 2 * touched_rows * dim * table_elem
    return least_time(flops, nbytes, H100_PEAKS["fp32_flops"])


def walk_call_least(walks: int, walk_length: int):
    """Least (seconds, bound) of one walk call, counted from its shapes: the
    int32 walk matrix written once, and per nominal step at least one
    32-byte sector of the current node's row read; its FLOPs are a few a
    step, far below."""
    nbytes = walks * (walk_length + 1) * 4 + walks * walk_length * SECTOR
    return least_time(0.0, nbytes, H100_PEAKS["fp32_flops"])
