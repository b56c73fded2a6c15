"""Sparse-row update application: ``table[i] -= lr * capped sum of rows``.

Counterpart of ``pecanpy_tpu/ops/apply.py``. The SGNS step ends with two
such updates per chunk-step (W_in, and W_out with two merged streams).

On a CUDA table the update runs in two parts, as in the JAX package:

1. stream prep in plain torch: a stable sort of the ids (or of the
   composite keys ``id * 2 + stream`` when two streams merge), the
   per-group scale ``lr * min(total, cap) / total`` from each group's
   bounds, found by searching the sorted keys for themselves, and the
   counts' cumsum (``_sorted_scales``; the JAX package uses scans here),
   and the payload gathered into sorted order and scaled. After this,
   application is linear: ``table -= sum of scaled rows``;
2. ``apply_sorted_stream``: the hand-written CUDA kernel
   (``csrc/apply.cu``, the port of the Pallas ``_applier_kernel``),
   which updates the table IN PLACE, touching only the rows the stream
   names: a warp per segment of at most ``long_segment_rows()`` rows,
   then a second pass that splits each longer segment's columns into
   slabs streamed through shared memory. bf16 tables accumulate in f32
   and write back with stochastic rounding. With
   ``PECANPY_TPU_APPLY_V2=1`` (``APPLY_V2``) the update runs
   ``apply_sorted_stream_windowed`` instead (``csrc/apply_v2.cu``, the
   port of ``_applier_kernel_v2``), for rows of at most
   ``MAX_WINDOWED_DIM`` elements (wider ones stay on the first kernel,
   ``_cuda_applier``): the same function, bit-equal to the first kernel,
   from persistent blocks that each take a balanced range of the stream
   (``windowed_partition``), find their own first and last rows in the
   kernel, and stream them in 16-row windows through a four-stage ring
   in shared memory.

On a CPU table ``apply_mean_updates`` / ``apply_mean_updates_two`` take
the scatter path, the same one the JAX package takes without Pallas
(``use_pallas=False``), and also write into the table in place.

Known difference from the TPU kernel: the payload stays f32 here, where
the TPU ships it as bf16 into bf16 one-hot matmuls (``DOT_BF16``). The
port is therefore closer to the f32 scatter semantics.
"""
import os
from typing import Union

import torch

from pecanpy_tpu_torch.ops import _kernels
from pecanpy_tpu_torch.utils import trace

DEFAULT_UPDATE_CAP = 4.0  # max "pair-steps" a row absorbs per application
_EPS = 1e-9
_MASK32 = 0xFFFFFFFF

Cap = Union[float, torch.Tensor]


def _row_step(sums, cnts, lr, cap):
    """-lr * sum * min(cnt, cap) / cnt per row (``_row_step`` of the JAX
    package): rows with few contributions take the plain gradient sum,
    hot rows are capped at ``cap`` pair-steps per application."""
    scale = torch.clamp(cnts, max=cap) / torch.clamp(cnts, min=_EPS)
    return lr * sums * scale


def _apply_scatter(table, ids, upd, cnt, lr, cap):
    """Scatter reference path, in place (the CPU path)."""
    ids = ids.long()
    t32 = table.to(torch.float32)
    sums = torch.zeros_like(t32).index_add_(0, ids, upd.to(torch.float32))
    cnts = torch.zeros(
        table.shape[0], dtype=torch.float32, device=table.device
    ).index_add_(0, ids, cnt.to(torch.float32))
    table.copy_(t32 - _row_step(sums, cnts[:, None], lr, cap))
    return table


def _sorted_scales(keys_s, cnt_s, lr, cap: Cap):
    """Entry-wise ``lr * min(total, cap) / total`` over a sorted stream.

    ``total`` is the summed count of the entry's key group: with ``cum``
    the inclusive cumsum of the counts, ``cum[hi] - (cum - cnt)[lo]``,
    where ``lo`` and ``hi`` are the group's first and last positions,
    found by searching the sorted keys for themselves (left and right).
    These are the positions the JAX package's scans select (a cummax of
    the exclusive cumsum masked to group starts, a reversed cummin of
    ``cum`` masked to group ends), and each operand is the same f32 op,
    so the scales are those of the scans to the bit. The JAX package
    avoids a search because XLA runs it as log(R) serial gather rounds
    on the TPU; on a GPU it is the scans that are slow (torch runs a 1-D
    scan with indices in one thread block: about 0.3 ms at R = 100k on
    an H100), while the searches spread over the card. Exact for the
    integer-valued counts SGNS produces.
    """
    cnt_f = cnt_s.to(torch.float32)
    cum = torch.cumsum(cnt_f, dim=0)  # inclusive
    lo = torch.searchsorted(keys_s, keys_s, out_int32=True)
    hi = torch.searchsorted(keys_s, keys_s, right=True, out_int32=True) - 1
    tot = cum.index_select(0, hi) - (cum - cnt_f).index_select(0, lo)
    if isinstance(cap, torch.Tensor):
        capped = torch.minimum(tot, cap.to(device=tot.device, dtype=torch.float32))
    else:  # a kernel argument: no copy from host memory, no wait
        capped = torch.clamp(tot, max=cap)
    return lr * capped / torch.clamp(tot, min=_EPS)


# -- stochastic rounding bits (the kernel's counter-based hash) ------------


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32), without overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def sr_bits(seed: int, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The kernel's random bits ``fmix32(fmix32(fmix32(seed) ^ row) ^ col)``
    as int64 values in [0, 2^32), broadcast over ``rows`` and ``cols``."""
    s = _fmix32(torch.tensor(seed & _MASK32, dtype=torch.int64))
    h = _fmix32(s ^ rows.to(torch.int64))
    return _fmix32(h ^ cols.to(torch.int64))


def stochastic_round_bf16(
    x: torch.Tensor, seed: int, rows: torch.Tensor
) -> torch.Tensor:
    """f32 [len(rows), D] -> bf16 with the kernel's stochastic rounding:
    add the low 16 random bits of (seed, row, col) to the f32 bit
    pattern, then truncate."""
    cols = torch.arange(x.shape[1], device=x.device)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    r16 = sr_bits(seed, rows[:, None], cols[None, :]) & 0xFFFF
    out = (bits + r16) & 0xFFFF0000
    out = out - ((out >> 31) << 32)  # back to the signed int32 range
    return out.to(torch.int32).view(torch.float32).to(torch.bfloat16)


# -- the kernel and its plain version --------------------------------------


def _ordered_index_add(out, idx, values):
    """``out.index_add_(0, idx, values)``, adding the values of each row in
    the order given: one pass per occurrence rank, so no pass adds two
    values to one row. The f32 sums are then the kernels' to the bit,
    where a single CUDA ``index_add_`` adds a row's values with atomics in
    no fixed order."""
    n = idx.numel()
    if n == 0:
        return out
    order = torch.argsort(idx, stable=True)
    srt = idx[order]
    pos = torch.arange(n, device=idx.device)
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = srt[1:] != srt[:-1]
    first = torch.cummax(torch.where(head, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    by_rank = torch.argsort(rank, stable=True)
    off = 0
    for count in torch.bincount(rank).tolist():
        sel = by_rank[off:off + count]
        out.index_add_(0, idx[sel], values[sel])
        off += count
    return out


def apply_sorted_stream_plain(
    table: torch.Tensor, ids_s: torch.Tensor, upd_s: torch.Tensor, seed: int = 0
) -> torch.Tensor:
    """Plain torch version of ``apply_sorted_stream`` (same contract).

    Per touched row the f32 sum of its rows, taken from 0 in stream order
    as the kernel takes it, subtracted in f32; bf16 tables write back with
    the kernel's stochastic rounding bits.
    """
    uniq, inv = torch.unique_consecutive(ids_s.long(), return_inverse=True)
    sums = torch.zeros(
        (uniq.numel(), table.shape[1]), dtype=torch.float32, device=table.device)
    _ordered_index_add(sums, inv, upd_s.to(torch.float32))
    return _write_rows(table, uniq, sums, seed)


def _write_rows(table, rows, sums, seed):
    """``table[rows] -= sums`` in f32; a bf16 table rounds stochastically."""
    new = table[rows].to(torch.float32) - sums
    if table.dtype == torch.bfloat16:
        new = stochastic_round_bf16(new, seed, rows)
    table[rows] = new
    return table


def apply_sorted_stream(
    table: torch.Tensor, ids_s: torch.Tensor, upd_s: torch.Tensor, seed: int = 0
) -> torch.Tensor:
    """``table[i] -= sum of upd_s rows with id i``, IN PLACE; returns table.

    Args:
        table: [N, D] float32 or bfloat16, contiguous.
        ids_s: [R] int32 destination rows, sorted ascending.
        upd_s: [R, D] float32 payload rows (already scaled).
        seed: stochastic-rounding seed (bf16 tables only).

    Rows no id names are neither read nor written. A CUDA table runs the
    CUDA kernel of ``csrc/apply.cu`` on the current stream (its short and
    long passes, counted as one launch in ``apply_sorted_stream.launches``)
    or raises; a CPU table runs ``apply_sorted_stream_plain``.
    """
    if table.device.type == "cpu":
        return apply_sorted_stream_plain(table, ids_s, upd_s, seed)
    _check_cuda_stream(table, ids_s, upd_s, "apply_sorted_stream")
    r = ids_s.shape[0]
    if r == 0:
        return table
    lib = _kernels.load()
    fn = (
        lib.pecanpy_apply_sorted_bf16
        if table.dtype == torch.bfloat16
        else lib.pecanpy_apply_sorted_f32
    )
    stream = torch.cuda.current_stream(table.device).cuda_stream
    scratch = _long_pass_scratch(table.device, stream, lib.pecanpy_apply_sorted_scratch(r))
    code = fn(
        table.data_ptr(), ids_s.data_ptr(), upd_s.data_ptr(), r,
        table.shape[0], table.shape[1], seed & _MASK32,
        scratch.data_ptr(), scratch.numel(), stream,
    )
    _kernels.check(lib, code, "apply_sorted_stream")
    apply_sorted_stream.launches += 1
    return table


apply_sorted_stream.launches = 0

# the long pass's list of segments, one buffer per (device, stream): a
# launch on one stream never shares it with a launch on another
_SCRATCH = {}


def _long_pass_scratch(device, stream, need):
    """An int64 device buffer of at least ``need`` elements (and at least
    one), reused across calls on ``stream``."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.empty(max(need, 1), dtype=torch.int64, device=device)
        _SCRATCH[key] = buf
    return buf


def long_segment_rows() -> int:
    """The most rows of a segment that kernel 2.1's short pass sums; longer
    segments take its long pass (``csrc/apply.cu``: kLongRows). Builds
    the kernels: CUDA only."""
    return _kernels.load().pecanpy_apply_long_rows()


def _check_cuda_stream(table, ids_s, upd_s, what):
    """Raise on anything the CUDA appliers do not take."""
    if table.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {table.device}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if ids_s.dtype != torch.int32 or upd_s.dtype != torch.float32:
        raise TypeError(
            f"ids_s must be int32 and upd_s float32, got {ids_s.dtype} and "
            f"{upd_s.dtype}"
        )
    r = ids_s.shape[0]
    if (
        table.dim() != 2
        or ids_s.dim() != 1
        or tuple(upd_s.shape) != (r, table.shape[1])
    ):
        raise ValueError(
            f"shapes: table {tuple(table.shape)}, ids_s {tuple(ids_s.shape)}, "
            f"upd_s {tuple(upd_s.shape)}; want [N, D], [R], [R, D]"
        )
    if not (
        table.is_contiguous() and ids_s.is_contiguous() and upd_s.is_contiguous()
    ):
        raise ValueError("table, ids_s and upd_s must be contiguous")
    if ids_s.device != table.device or upd_s.device != table.device:
        raise ValueError("table, ids_s and upd_s must be on one device")
    if table.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(
            f"table is on {table.device} but the current CUDA device is "
            f"{torch.cuda.current_device()}; the kernel launches on the "
            "current device"
        )


# -- the windowed kernel and its plain version -----------------------------

# Table rows per tile and stream rows per window of the plain version's
# plan (the JAX package's, at Hopper-sized tiles). The kernel has no tiles;
# its windows are WINDOW_ROWS stream rows (``csrc/apply_v2.cu``: kWin).
WINDOW_TILE = 32
WINDOW_ROWS = 16
# widest row the kernel's shared memory holds: four f32 payload windows,
# four windows of table rows and a carry row within the 227 KB a block may
# use (``csrc/apply_v2.cu``: kMaxDim)
MAX_WINDOWED_DIM = 448


def window_plan(ids_s: torch.Tensor, num_rows: int, tile: int = WINDOW_TILE,
                window: int = WINDOW_ROWS):
    """Per-tile slices of a sorted stream, in ``window``-row windows.

    The plan of the JAX package's windowed driver (``_finalize_and_run``
    and ``_apply_pallas_v2``): ``bounds[t]`` is the first stream row whose
    id reaches tile t's first table row (a searchsorted of the tile edges);
    tile t reads the stream windows ``w0[t] .. w0[t] + nw[t] - 1``, those
    aligned ``window``-row blocks that overlap ``[bounds[t], bounds[t+1])``
    (none for an empty slice). Returns int32 (bounds [T + 1], w0 [T],
    nw [T]) with ``T = ceil(num_rows / tile)``.
    """
    n_tiles = -(-num_rows // tile)
    edges = torch.arange(n_tiles + 1, dtype=torch.int32, device=ids_s.device) * tile
    bounds = torch.searchsorted(ids_s, edges, out_int32=True)
    lo, hi = bounds[:-1], bounds[1:]
    w0 = torch.div(lo, window, rounding_mode="floor")
    nw = torch.clamp(-torch.div(w0 * window - hi, window, rounding_mode="floor"), min=0)
    nw = torch.where(hi > lo, nw, 0).to(torch.int32)
    return bounds, w0, nw


def windowed_partition(ids_s: torch.Tensor, grid: int):
    """The stream rows each block of the windowed kernel owns.

    The rule ``csrc/apply_v2.cu`` computes in the kernel, written out for
    the tests (the CUDA route does not call it): block b takes the range
    ``[b R // grid, (b + 1) R // grid)`` of the sorted stream; a segment
    (the rows of one id) belongs to the block whose range holds its first
    row, which finishes it past its range's end; segments of ids < 0
    belong to no block. Segments of ids >= N are owned but never
    written. Returns int64 (start [grid], end [grid]): block b folds the rows
    ``[start[b], end[b])``, empty where start == end.
    """
    ids = ids_s.to(torch.int64)
    r = ids.numel()
    s = torch.arange(grid + 1, dtype=torch.int64, device=ids.device) * r // grid
    lo, hi = s[:-1], s[1:]
    if r == 0:
        return lo, lo.clone()
    prev = torch.where(lo > 0, ids[torch.clamp(lo - 1, min=0)], -1)
    start = torch.searchsorted(ids, torch.clamp(prev, min=-1), right=True)
    last = ids[torch.clamp(hi - 1, min=0)]
    end = torch.where(hi < r, torch.searchsorted(ids, last, right=True), r)
    owns = (lo < hi) & (start < hi)
    start = torch.where(owns, start, lo)
    return start, torch.where(owns, end, lo)


def windowed_grid(table: torch.Tensor, upd_s: torch.Tensor) -> int:
    """The number of blocks a windowed launch on these CUDA tensors uses
    (SMs times resident blocks, as the launcher computes it)."""
    lib = _kernels.load()
    grid = lib.pecanpy_apply_windowed_grid(
        table.data_ptr(), upd_s.data_ptr(), table.shape[1],
        int(table.dtype == torch.bfloat16))
    if grid <= 0:
        _kernels.check(lib, -grid, "windowed_grid")
    return grid


def apply_sorted_stream_windowed_plain(
    table: torch.Tensor, ids_s: torch.Tensor, upd_s: torch.Tensor, seed: int = 0,
    tile: int = WINDOW_TILE, window: int = WINDOW_ROWS,
) -> torch.Tensor:
    """Plain torch version of ``apply_sorted_stream_windowed``.

    Follows the kernel's plan: every tile reads its stream windows, keeps
    the rows whose id falls in the tile (rows of neighbouring tiles ride
    the shared boundary windows and are masked out, as are ids outside
    [0, N)), sums each table row's payload in a [tile, D] f32 accumulator
    in stream order from 0, and writes back the rows its slice names. The
    tiles run at once here, each in its own accumulator block.
    """
    n, d = table.shape
    r = ids_s.shape[0]
    if r == 0:
        return table
    dev = table.device
    _, w0, nw = window_plan(ids_s, n, tile, window)
    tiles = torch.repeat_interleave(torch.arange(nw.numel(), device=dev), nw.long())
    first = torch.cumsum(nw.long(), 0) - nw.long()  # each tile's first visit
    visit_w = w0.long()[tiles] + torch.arange(tiles.numel(), device=dev) - first[tiles]
    rows = visit_w[:, None] * window + torch.arange(window, device=dev)[None, :]
    ok = rows < r
    rows = torch.clamp(rows, max=r - 1)
    ids = ids_s.long()[rows]
    local = ids - tiles[:, None] * tile
    ok &= (local >= 0) & (local < tile) & (ids < n)
    # visits are tile-major and windows ascending: flattening keeps
    # stream order, and every kept row lands in exactly one visit
    slot = (tiles[:, None] * tile + local)[ok]
    acc = torch.zeros((nw.numel() * tile, d), dtype=torch.float32, device=dev)
    _ordered_index_add(acc, slot, upd_s.to(torch.float32)[rows[ok]])
    named = torch.unique_consecutive(ids[ok])
    return _write_rows(table, named, acc[named], seed)


def apply_sorted_stream_windowed(
    table: torch.Tensor, ids_s: torch.Tensor, upd_s: torch.Tensor, seed: int = 0
) -> torch.Tensor:
    """``table[i] -= sum of upd_s rows with id i``, IN PLACE; returns table.

    The same contract and result as ``apply_sorted_stream``, through the
    windowed kernel of ``csrc/apply_v2.cu`` (the port of the Pallas
    ``_applier_kernel_v2``), which computes its own partition of the
    stream (``windowed_partition``). Ids outside [0, N) are dropped.
    Rows of at most ``MAX_WINDOWED_DIM`` elements: a wider CUDA table
    raises here (the entry points under ``APPLY_V2`` send it to
    ``apply_sorted_stream``, ``_cuda_applier``). A CUDA table launches
    the kernel on the current stream (counted in
    ``apply_sorted_stream_windowed.launches``) or raises; a CPU table runs
    ``apply_sorted_stream_windowed_plain``.
    """
    if table.device.type == "cpu":
        return apply_sorted_stream_windowed_plain(table, ids_s, upd_s, seed)
    _check_cuda_stream(table, ids_s, upd_s, "apply_sorted_stream_windowed")
    if table.shape[1] > MAX_WINDOWED_DIM:
        raise ValueError(
            f"the windowed applier takes rows of at most {MAX_WINDOWED_DIM} "
            f"elements, got {table.shape[1]}"
        )
    if ids_s.shape[0] == 0:
        return table
    lib = _kernels.load()
    fn = (
        lib.pecanpy_apply_windowed_bf16
        if table.dtype == torch.bfloat16
        else lib.pecanpy_apply_windowed_f32
    )
    stream = torch.cuda.current_stream(table.device).cuda_stream
    code = fn(
        table.data_ptr(), ids_s.data_ptr(), upd_s.data_ptr(), ids_s.shape[0],
        table.shape[0], table.shape[1], seed & _MASK32, stream,
    )
    _kernels.check(lib, code, "apply_sorted_stream_windowed")
    apply_sorted_stream_windowed.launches += 1
    return table


apply_sorted_stream_windowed.launches = 0


# -- stream prep and the public entry points -------------------------------

# PECANPY_TPU_APPLY_V2=1 sends every CUDA table update with rows of at most
# MAX_WINDOWED_DIM elements through the windowed kernel (read at import, as
# the JAX package reads it; the entry points read this attribute at call
# time, so it can be set afterwards).
APPLY_V2 = os.environ.get("PECANPY_TPU_APPLY_V2", "0") == "1"


def _cuda_applier(table: torch.Tensor):
    """The kernel a CUDA table's update runs: kernel 2.1
    (``apply_sorted_stream``) by default; under ``APPLY_V2`` the windowed
    kernel, unless the table's rows are wider than ``MAX_WINDOWED_DIM``:
    those take kernel 2.1, which has no width limit and is bit-equal to
    the windowed kernel (the JAX package pads such rows instead; the
    function is the same)."""
    if APPLY_V2 and table.shape[1] <= MAX_WINDOWED_DIM:
        return apply_sorted_stream_windowed
    return apply_sorted_stream


def sorted_stream_one(ids, upd, cnt, lr, cap: Cap):
    """Sort one stream by id and pre-scale its payload: (ids_s, upd_s)."""
    ids_s, order = torch.sort(ids.to(torch.int32), stable=True)
    scale = _sorted_scales(ids_s, cnt.to(torch.float32)[order], lr, cap)
    upd_s = upd.to(torch.float32)[order] * scale[:, None]
    return ids_s.contiguous(), upd_s.contiguous()


def sorted_stream_two(ids_a, upd_a, cnt_a, ids_b, upd_b, cnt_b, lr,
                      cap_a: float, cap_b: float):
    """Merge two streams under the key ``id * 2 + stream``, sort, and
    pre-scale each (id, stream) group with its own cap: (ids_s, upd_s)."""
    keys = torch.cat([ids_a.to(torch.int64) * 2, ids_b.to(torch.int64) * 2 + 1])
    upd = torch.cat([upd_a.to(torch.float32), upd_b.to(torch.float32)])
    cnt = torch.cat([cnt_a.to(torch.float32), cnt_b.to(torch.float32)])
    keys_s, order = torch.sort(keys, stable=True)
    cap_s = torch.where((keys_s & 1) == 1, cap_b, cap_a)
    scale = _sorted_scales(keys_s, cnt[order], lr, cap_s)
    upd_s = upd[order] * scale[:, None]
    return (keys_s >> 1).to(torch.int32).contiguous(), upd_s.contiguous()


def apply_mean_updates(
    table: torch.Tensor,
    ids: torch.Tensor,
    upd: torch.Tensor,
    cnt: torch.Tensor,
    lr: float,
    cap: float = DEFAULT_UPDATE_CAP,
    rng_seed: int = 0,
) -> torch.Tensor:
    """table[i] -= lr * capped sum of the upd rows with id i, IN PLACE.

    The rule is ``_row_step``'s: the gradient sum, scaled by
    ``min(count, cap) / count``. Rows absent from ``ids`` are unchanged;
    entries with cnt 0 and zero upd rows are no-ops. ``ids`` must be
    < table rows. Returns ``table``.

    A CUDA table's stream prep is the span ``pecanpy.apply.prep``, the
    kernel's launch ``pecanpy.apply.launch``.
    """
    if table.device.type == "cpu":
        return _apply_scatter(table, ids, upd, cnt, lr, cap)
    if ids.shape[0] == 0:
        return table
    with trace.span("pecanpy.apply.prep"):
        ids_s, upd_s = sorted_stream_one(ids, upd, cnt, lr, cap)
    with trace.span("pecanpy.apply.launch"):
        return _cuda_applier(table)(table, ids_s, upd_s, rng_seed)


def apply_mean_updates_two(
    table: torch.Tensor,
    ids_a: torch.Tensor,
    upd_a: torch.Tensor,
    cnt_a: torch.Tensor,
    ids_b: torch.Tensor,
    upd_b: torch.Tensor,
    cnt_b: torch.Tensor,
    lr: float,
    cap_a: float = DEFAULT_UPDATE_CAP,
    cap_b: float = DEFAULT_UPDATE_CAP,
    rng_seed: int = 0,
) -> torch.Tensor:
    """Apply two capped-mean update streams in ONE table pass, IN PLACE.

    Semantics: ``apply_mean_updates(apply_mean_updates(table, a...),
    b...)``, because application is linear in the pre-scaled rows. The
    streams keep separate normalization groups (counts and caps): merging
    them into one mean would let the more numerous stream drown the other.
    ``ids`` must stay < 2^62. Returns ``table``.
    """
    if table.device.type == "cpu":
        _apply_scatter(table, ids_a, upd_a, cnt_a, lr, cap_a)
        return _apply_scatter(table, ids_b, upd_b, cnt_b, lr, cap_b)
    if ids_a.shape[0] + ids_b.shape[0] == 0:
        return table
    with trace.span("pecanpy.apply.prep"):
        ids_s, upd_s = sorted_stream_two(
            ids_a, upd_a, cnt_a, ids_b, upd_b, cnt_b, lr, cap_a, cap_b
        )
    with trace.span("pecanpy.apply.launch"):
        return _cuda_applier(table)(table, ids_s, upd_s, rng_seed)
