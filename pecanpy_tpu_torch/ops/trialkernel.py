"""The hub walkers' rejection trial as two CUDA kernels.

Counterpart of ``pecanpy_tpu/ops/trialkernel.py``: the Pallas kernels
``_k1_propose`` and ``_k2_accept`` become ``trial_propose`` and
``trial_accept`` in ``csrc/trial.cu`` (design notes there). Together they
compute ``rejection._trial_block`` for node2vec (extend=False) on the
carried fused rows, in two launches per call:

    trial_propose:  cur rows + alias slots + draws  ->  (x, w(cur, x)) per trial
    trial_accept:   prev rows + hash buckets + x    ->  (chosen, got, chosen_w)

``trial_block_fused`` is the entry point the hub engines call. On CPU
tensors it runs the plain version, ``rejection._trial_block``; on CUDA
tensors it launches both kernels or raises. Each kernel's wrapper counts
its launches in ``.launches``. ``trial_propose_plain`` and
``trial_accept_plain`` are the plain versions of the two halves, for
holding each kernel against its own function on the card. The draws
come as one ``RoundDraws``, the [T, B] and [T, 4, B] blocks the kernels
read as they are.
"""
import torch

from pecanpy_tpu_torch.ops import _kernels, rejection
from pecanpy_tpu_torch.ops.hubs import EP_WIDTH
from pecanpy_tpu_torch.ops.layout import HB_WIDTH, DeviceCSR
from pecanpy_tpu_torch.ops.rejection import RoundDraws

MAX_TRIALS = 8  # csrc/trial.cu:kMaxTrials


def _check_cuda(dg: DeviceCSR, rows: torch.Tensor, trials: int, what: str):
    if rows.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {rows.device}")
    if rows.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(
            f"{what}: rows are on {rows.device} but the current CUDA device "
            f"is {torch.cuda.current_device()}"
        )
    if dg.fused.device != rows.device:
        raise ValueError(f"{what}: rows and graph tables on different devices")
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"{what}: rows must be contiguous [B, C * dpad] float32")
    if rows.shape[1] != len(dg.channels) * dg.dpad or dg.channels[:2] != ("nbr", "wgt"):
        raise ValueError(f"{what}: rows do not match the graph's fused layout")
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


def trial_propose(
    dg: DeviceCSR,
    draws: RoundDraws,
    prev: torch.Tensor,
    cur_rows: torch.Tensor,
    theta=None,
    wp=None,
    use_cdf: bool = False,
):
    """Launch ``trial_propose``: ([T, B] int32 x, [T, B] float32 w(cur, x))."""
    b, trials = cur_rows.shape[0], draws.kk.shape[0]
    _check_cuda(dg, cur_rows, trials, "trial_propose")
    dev = cur_rows.device
    prev = _lane_vector(prev, b, torch.int32, dev, "prev")
    if (theta is None) != (wp is None):
        raise ValueError("theta and wp come together")
    if theta is not None:
        theta = _lane_vector(theta, b, torch.float32, dev, "theta")
        wp = _lane_vector(wp, b, torch.float32, dev, "wp")
    kk, u = _draw_blocks(draws, trials, b, dev)
    cdf_off = dg.channels.index("cdf") * dg.dpad if use_cdf else -1
    ep = dg.edge_pack.contiguous()
    x = torch.empty((trials, b), dtype=torch.int32, device=dev)
    w = torch.empty((trials, b), dtype=torch.float32, device=dev)
    lib = _kernels.load()
    code = lib.pecanpy_trial_propose(
        cur_rows.data_ptr(), cur_rows.shape[1], dg.dpad, cdf_off,
        ep.data_ptr(), ep.numel() // EP_WIDTH, kk.data_ptr(), u.data_ptr(),
        theta.data_ptr() if theta is not None else None,
        wp.data_ptr() if wp is not None else None,
        prev.data_ptr(), x.data_ptr(), w.data_ptr(), b, trials, dg.num_nodes,
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
    prev_rows: torch.Tensor,
    p: float,
    q: float,
    alpha_np: float,
    use_atom: bool,
    force_ok=None,
):
    """Launch ``trial_accept``: ([B] int32 chosen, [B] bool got,
    [B] float32 w(cur, chosen)) from ``trial_propose``'s (x, wx)."""
    b, trials = prev_rows.shape[0], draws.kk.shape[0]
    _check_cuda(dg, prev_rows, trials, "trial_accept")
    dev = prev_rows.device
    prev = _lane_vector(prev, b, torch.int32, dev, "prev")
    if tuple(x.shape) != (trials, b) or x.dtype != torch.int32 or x.device != dev:
        raise ValueError(f"x must be a [{trials}, {b}] int32 tensor on {dev}")
    if tuple(wx.shape) != (trials, b) or wx.dtype != torch.float32 or wx.device != dev:
        raise ValueError(f"wx must be a [{trials}, {b}] float32 tensor on {dev}")
    x, wx = x.contiguous(), wx.contiguous()
    if force_ok is not None:
        force_ok = _lane_vector(force_ok, b, torch.bool, dev, "force_ok")
    _, u = _draw_blocks(draws, trials, b, dev)
    hb = dg.hbuckets.contiguous()
    chosen = torch.empty(b, dtype=torch.int32, device=dev)
    got = torch.empty(b, dtype=torch.bool, device=dev)
    chosen_w = torch.empty(b, dtype=torch.float32, device=dev)
    lib = _kernels.load()
    code = lib.pecanpy_trial_accept(
        prev_rows.data_ptr(), prev_rows.shape[1], dg.dpad,
        hb.data_ptr(), hb.numel() // HB_WIDTH, x.data_ptr(),
        wx.data_ptr(), u.data_ptr(), prev.data_ptr(),
        force_ok.data_ptr() if force_ok is not None else None,
        1.0 / p, 1.0 / q, alpha_np, int(use_atom),
        chosen.data_ptr(), got.data_ptr(), chosen_w.data_ptr(), b, trials,
        dg.num_nodes, torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(lib, code, "trial_accept")
    trial_accept.launches += 1
    return chosen, got, chosen_w


trial_accept.launches = 0


def trial_propose_plain(dg, draws, prev, cur_rows, theta=None, wp=None, use_cdf=False):
    """Plain torch version of ``trial_propose`` (same contract)."""
    out = [
        rejection._propose_trial(dg, d, prev, cur_rows, theta, wp, use_cdf)
        for d in draws.trials()
    ]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def trial_accept_plain(
    dg, draws, x, wx, prev, prev_rows, p, q, alpha_np, use_atom, force_ok=None
):
    """Plain torch version of ``trial_accept`` (same contract)."""
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
    cur_rows: torch.Tensor,
    prev_rows: torch.Tensor,
    p: float,
    q: float,
    alpha_np: float,
    theta=None,
    wp=None,
    use_cdf: bool = False,
    force_ok=None,
):
    """``rejection._trial_block`` for node2vec (extend=False).

    Returns (chosen [B] int32, got [B] bool, w(cur, chosen) [B] float32)
    with first-accepted-wins semantics. CPU tensors take the plain
    version; CUDA tensors launch ``trial_propose`` and ``trial_accept``.
    """
    if cur_rows.device.type == "cpu":
        return rejection._trial_block(
            dg, draws.trials(), prev, cur_rows, prev_rows, p, q, False, alpha_np,
            theta, wp, mode="auto", use_cdf=use_cdf, force_ok=force_ok,
        )
    x, wx = trial_propose(dg, draws, prev, cur_rows, theta, wp, use_cdf)
    return trial_accept(
        dg, draws, x, wx, prev, prev_rows, p, q, alpha_np, theta is not None,
        force_ok,
    )
