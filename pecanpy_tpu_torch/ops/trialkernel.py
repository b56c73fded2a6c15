"""The hub walkers' rejection trial as two CUDA kernels.

Counterpart of ``pecanpy_tpu/ops/trialkernel.py``: the Pallas kernels
``_k1_propose`` and ``_k2_accept`` become ``trial_propose`` and
``trial_accept`` in ``csrc/trial.cu`` (design notes there). Together they
compute ``rejection._trial_block`` for node2vec (extend=False), in two
launches per call, on [B] int32 node ids: the kernels read each lane's
rows from the graph's tables themselves.

    trial_propose:  cur ids + fused rows + alias slots + draws  ->  (x, w(cur, x)) per trial
    trial_accept:   prev ids + fused rows + hash buckets + x    ->  (chosen, got, chosen_w)

``trial_block_fused`` is the entry point the hub engines call. On CUDA
tensors each wrapper launches its kernel or raises, and counts its
launches in ``.launches``; on CPU tensors it takes its plain version,
``trial_propose_plain`` or ``trial_accept_plain``, which chip_smoke.py
and the ``gpu`` tests also hold each kernel against on the card. The
draws come as one ``RoundDraws``, the [T, B] and [T, 4, B] blocks the
kernels read as they are.
"""
import functools

import torch

from pecanpy_tpu_torch.ops import _kernels, rejection
from pecanpy_tpu_torch.ops.hubs import EP_WIDTH
from pecanpy_tpu_torch.ops.layout import HB_WIDTH, DeviceCSR
from pecanpy_tpu_torch.ops.rejection import RoundDraws

MAX_TRIALS = 8  # csrc/trial.cu:kMaxTrials
INT32_MAX = 2**31 - 1


def trial_grid(b: int, lanes_per_block: int) -> int:
    """Blocks of a trial-kernel launch over ``b`` lanes, ``lanes_per_block``
    lanes each (``csrc/trial.cu``: kThreads / kGroup). Raises past the
    int32 grid limit the kernel's entry point checks too."""
    blocks = -(-b // lanes_per_block)
    if blocks > INT32_MAX:
        raise ValueError(f"{b} lanes need {blocks} blocks, above the grid limit {INT32_MAX}")
    return blocks


@functools.lru_cache(maxsize=None)
def _lanes_per_block(lib) -> int:
    return lib.pecanpy_trial_lanes_per_block()


def _check_cuda(dg: DeviceCSR, ids: torch.Tensor, trials: int, what: str):
    if ids.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ids.device}")
    if ids.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(
            f"{what}: ids are on {ids.device} but the current CUDA device "
            f"is {torch.cuda.current_device()}"
        )
    fused, deg = dg.fused, dg.deg
    if fused.device != ids.device or deg.device != ids.device:
        raise ValueError(f"{what}: ids and graph tables on different devices")
    # float4 reads of each row: aligned base, row stride and channel widths
    if (
        fused.dtype != torch.float32 or fused.dim() != 2 or fused.stride(1) != 1
        or fused.stride(0) % 4 or fused.data_ptr() % 16 or dg.dpad % 4
    ):
        raise ValueError(f"{what}: fused must be [N, C * dpad] float32 rows, 16-byte aligned")
    if fused.shape[1] != len(dg.channels) * dg.dpad or dg.channels[:2] != ("nbr", "wgt"):
        raise ValueError(f"{what}: fused does not match the graph's channels")
    if deg.dtype != torch.int32 or tuple(deg.shape) != (dg.num_nodes,) or not deg.is_contiguous():
        raise ValueError(f"{what}: deg must be a contiguous [N] int32 tensor")
    if not 1 <= trials <= MAX_TRIALS:
        raise ValueError(f"{what}: trials must be in 1..{MAX_TRIALS}, got {trials}")


def _lane_vector(t, b, dtype, device, name):
    if t.dtype != dtype or tuple(t.shape) != (b,) or t.device != device:
        raise ValueError(f"{name} must be a [{b}] {dtype} tensor on {device}")
    return t.contiguous()


def _draw_blocks(draws: RoundDraws, trials, b, device):
    """The draws' [T, B] int32 kk and [T, 4, B] float32 u, checked."""
    kk, u = draws.kk.contiguous(), draws.u.contiguous()
    if (
        tuple(kk.shape) != (trials, b) or kk.dtype != torch.int32
        or tuple(u.shape) != (trials, 4, b) or u.dtype != torch.float32
        or kk.device != device or u.device != device
    ):
        raise ValueError(
            f"draws must be [{trials}, {b}] int32 kk and [{trials}, 4, {b}] "
            f"float32 u on {device}"
        )
    return kk, u


def _table(t: torch.Tensor, name: str) -> torch.Tensor:
    """A hub table as the kernels index it: contiguous, 16-byte aligned."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def trial_propose(
    dg: DeviceCSR,
    draws: RoundDraws,
    prev: torch.Tensor,
    cur: torch.Tensor,
    theta=None,
    wp=None,
    use_cdf: bool = False,
):
    """``trial_propose`` on [B] int32 node ids: ([T, B] int32 x, [T, B]
    float32 w(cur, x)). CPU tensors take ``trial_propose_plain``; CUDA
    tensors launch the kernel."""
    if cur.device.type == "cpu":
        return trial_propose_plain(dg, draws, prev, cur, theta, wp, use_cdf)
    b, trials = cur.shape[0], draws.kk.shape[0]
    _check_cuda(dg, cur, trials, "trial_propose")
    dev = cur.device
    cur = _lane_vector(cur, b, torch.int32, dev, "cur")
    prev = _lane_vector(prev, b, torch.int32, dev, "prev")
    if (theta is None) != (wp is None):
        raise ValueError("theta and wp come together")
    if theta is not None:
        theta = _lane_vector(theta, b, torch.float32, dev, "theta")
        wp = _lane_vector(wp, b, torch.float32, dev, "wp")
    kk, u = _draw_blocks(draws, trials, b, dev)
    cdf_off = dg.channels.index("cdf") * dg.dpad if use_cdf else -1
    ep = _table(dg.edge_pack, "edge_pack")
    x = torch.empty((trials, b), dtype=torch.int32, device=dev)
    w = torch.empty((trials, b), dtype=torch.float32, device=dev)
    if b == 0:
        return x, w
    lib = _kernels.load()
    code = lib.pecanpy_trial_propose(
        dg.fused.data_ptr(), dg.fused.stride(0), dg.dpad, cdf_off, dg.deg.data_ptr(),
        ep.data_ptr(), ep.numel() // EP_WIDTH, kk.data_ptr(), u.data_ptr(),
        theta.data_ptr() if theta is not None else None,
        wp.data_ptr() if wp is not None else None,
        prev.data_ptr(), cur.data_ptr(), x.data_ptr(), w.data_ptr(), b, trials,
        dg.num_nodes, trial_grid(b, _lanes_per_block(lib)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(lib, code, "trial_propose")
    trial_propose.launches += 1
    return x, w


trial_propose.launches = 0


def trial_accept(
    dg: DeviceCSR,
    draws: RoundDraws,
    x: torch.Tensor,
    wx: torch.Tensor,
    prev: torch.Tensor,
    p: float,
    q: float,
    alpha_np: float,
    use_atom: bool,
    force_ok=None,
):
    """``trial_accept`` on [B] int32 node ids: ([B] int32 chosen, [B] bool
    got, [B] float32 w(cur, chosen)) from ``trial_propose``'s (x, wx). CPU
    tensors take ``trial_accept_plain``; CUDA tensors launch the kernel."""
    if prev.device.type == "cpu":
        return trial_accept_plain(dg, draws, x, wx, prev, p, q, alpha_np, use_atom, force_ok)
    b, trials = prev.shape[0], draws.kk.shape[0]
    _check_cuda(dg, prev, trials, "trial_accept")
    dev = prev.device
    prev = _lane_vector(prev, b, torch.int32, dev, "prev")
    if tuple(x.shape) != (trials, b) or x.dtype != torch.int32 or x.device != dev:
        raise ValueError(f"x must be a [{trials}, {b}] int32 tensor on {dev}")
    if tuple(wx.shape) != (trials, b) or wx.dtype != torch.float32 or wx.device != dev:
        raise ValueError(f"wx must be a [{trials}, {b}] float32 tensor on {dev}")
    x, wx = x.contiguous(), wx.contiguous()
    if force_ok is not None:
        force_ok = _lane_vector(force_ok, b, torch.bool, dev, "force_ok")
    _, u = _draw_blocks(draws, trials, b, dev)
    hb = _table(dg.hbuckets, "hbuckets")
    chosen = torch.empty(b, dtype=torch.int32, device=dev)
    got = torch.empty(b, dtype=torch.bool, device=dev)
    chosen_w = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return chosen, got, chosen_w
    lib = _kernels.load()
    code = lib.pecanpy_trial_accept(
        dg.fused.data_ptr(), dg.fused.stride(0), dg.dpad, dg.deg.data_ptr(),
        hb.data_ptr(), hb.numel() // HB_WIDTH, x.data_ptr(),
        wx.data_ptr(), u.data_ptr(), prev.data_ptr(),
        force_ok.data_ptr() if force_ok is not None else None,
        1.0 / p, 1.0 / q, alpha_np, int(use_atom),
        chosen.data_ptr(), got.data_ptr(), chosen_w.data_ptr(), b, trials,
        dg.num_nodes, trial_grid(b, _lanes_per_block(lib)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(lib, code, "trial_accept")
    trial_accept.launches += 1
    return chosen, got, chosen_w


trial_accept.launches = 0


def trial_propose_plain(dg, draws, prev, cur, theta=None, wp=None, use_cdf=False):
    """Plain torch version of ``trial_propose`` (same contract)."""
    cur_rows = dg.gather_rows(cur)
    out = [
        rejection._propose_trial(dg, d, prev, cur_rows, theta, wp, use_cdf)
        for d in draws.trials()
    ]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def trial_accept_plain(
    dg, draws, x, wx, prev, p, q, alpha_np, use_atom, force_ok=None
):
    """Plain torch version of ``trial_accept`` (same contract)."""
    prev_rows = dg.gather_rows(prev)
    oks = [
        rejection._accept_trial(
            dg, d, x[t], wx[t], prev, None, prev_rows, p, q, False, alpha_np,
            use_atom,
        )
        for t, d in enumerate(draws.trials())
    ]
    return rejection._combine(list(x), oks, list(wx), force_ok)


def trial_block_fused(
    dg: DeviceCSR,
    draws: RoundDraws,
    prev: torch.Tensor,
    cur: torch.Tensor,
    p: float,
    q: float,
    alpha_np: float,
    theta=None,
    wp=None,
    use_cdf: bool = False,
    force_ok=None,
):
    """``rejection._trial_block`` for node2vec (extend=False) on [B] int32
    node ids.

    Returns (chosen [B] int32, got [B] bool, w(cur, chosen) [B] float32)
    with first-accepted-wins semantics: ``trial_propose``, then
    ``trial_accept`` (on CPU tensors their plain halves, which compose to
    ``rejection._trial_block`` on the gathered rows).
    """
    x, wx = trial_propose(dg, draws, prev, cur, theta, wp, use_cdf)
    return trial_accept(
        dg, draws, x, wx, prev, p, q, alpha_np, theta is not None, force_ok,
    )
