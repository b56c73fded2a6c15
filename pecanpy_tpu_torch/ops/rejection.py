"""First-order proposals and the exact rejection trial for hub graphs.

Counterpart of ``pecanpy_tpu/ops/rejection.py`` (``alias_propose``,
``fused_propose``, ``propose``, ``uniform_propose``, ``membership``,
``_bias_from_membership``, ``_bias``, ``_single_trial`` and
``_trial_block``, ``_compact_indices`` and ``second_order_sample``).
A second-order step
where either endpoint may be a hub samples the exact node2vec law by
rejection, with O(1) memory accesses per trial whatever the degree:

1. **Proposal** x ~ w(cur, .): a hub row loads one resolved alias slot of
   ``edge_pack``; a capped row draws by inverse CDF over its carried fused
   row (the ``cdf`` channel when packed, else a prefix sum of ``wgt``).
   With the return-edge atom, x = prev with probability ``theta``.
2. **Bias** alpha(x) in {1/p, 1, 1/q} (node2vec+: the continuous alpha)
   from one membership test "is x a neighbor of prev": a hash-bucket
   probe for a hub prev, a compare against the carried row otherwise.
3. **Accept** with probability alpha(x) / alpha_np; x == prev always
   accepts when the atom is on.

Draws are arguments, so tests can feed the JAX key tree's own numbers:
a ``TrialDraws`` holds one trial's per-lane draws, a ``RoundDraws`` the
draws of a round's T trials as the kernels read them. The JAX package draws
``kk`` with ``jax.random.randint``; the port's own generator draws it as
``min(floor(u * max(deg, 1)), max(deg, 1) - 1)`` from a uniform u
(``slot_offsets``).

``_trial_block`` is the plain version of the CUDA trial kernels
(``ops/trialkernel.py``) and the only implementation for node2vec+.

``second_order_sample`` is the per-step sampler of the scan engine on hub
graphs (``PECANPY_TPU_AMORTIZED=0``): it draws the next node of every
lane that needs the rejection path within one walk step, in compacted
trial phases over the pending lanes until none is left. Its draws come
from a provider ``draws(phase, deg, trials) -> RoundDraws`` whose phase
index follows the JAX package's ``fold_in`` indices.
Left out: the tiered compaction (``tier_compact`` and its helpers, a
measured negative on the TPU).
"""
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from pecanpy_tpu_torch.ops import hubs as hubs_lib
from pecanpy_tpu_torch.ops import sampling
from pecanpy_tpu_torch.ops.layout import DeviceCSR
from pecanpy_tpu_torch.ops.transition import row_thresholds
from pecanpy_tpu_torch.utils import trace

_EPS = 1e-30

# The per-step sampler's phase sizes and trial counts (the JAX package's
# values): a first block of up to B / FIRST_FRACTION lanes per group with
# FIRST_ROUND_TRIALS trials, then sweeps of B / COMPACT_FRACTION lanes per
# group with SWEEP_TRIALS trials until no lane is pending, at most
# SWEEP_CAP of them.
FIRST_ROUND_TRIALS = 2
FIRST_FRACTION = 4
SWEEP_TRIALS = 4
COMPACT_FRACTION = 32
SWEEP_CAP = 256


class TrialDraws(NamedTuple):
    """One rejection trial's draws, each [B].

    kk: int32 alias-slot offset in ``[0, max(deg(cur), 1))``.
    u_self: uniform of the alias self/alias coin.
    u_small: uniform of the capped-row inverse-CDF draw.
    u_atom: uniform of the return-edge atom coin.
    u_acc: uniform of the accept test.
    """

    kk: torch.Tensor
    u_self: torch.Tensor
    u_small: torch.Tensor
    u_atom: torch.Tensor
    u_acc: torch.Tensor


class RoundDraws(NamedTuple):
    """One round's draws for T trials, in the layout the CUDA trial
    kernels read.

    kk: [T, B] int32 alias-slot offsets.
    u: [T, 4, B] float32 uniforms u_self, u_small, u_atom, u_acc.
    """

    kk: torch.Tensor
    u: torch.Tensor

    def trials(self) -> List[TrialDraws]:
        """Per-trial ``TrialDraws`` (views, no copies)."""
        return [TrialDraws(kk, *u) for kk, u in zip(self.kk, self.u)]

    @staticmethod
    def stack(draws: List[TrialDraws]) -> "RoundDraws":
        return RoundDraws(
            torch.stack([d.kk for d in draws]),
            torch.stack([torch.stack(d[1:]) for d in draws]),
        )


def slot_offsets(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """[B] int32 offsets uniform in ``[0, max(deg, 1))`` from uniforms u."""
    span = torch.clamp(deg, min=1)
    kk = torch.floor(u * span.to(torch.float32)).to(torch.int32)
    return torch.minimum(kk, span - 1)


def hub_bucket(x: torch.Tensor, hbase: torch.Tensor, hlog: torch.Tensor):
    """[B] global bucket row of key x in the hash of a hub with bucket base
    ``hbase`` and ``2^hlog`` buckets: the uint32 Knuth hash, computed in
    int64 (wrapping int64 products keep the low 32 bits exact)."""
    mask = (1 << torch.clamp(hlog, 0, 30).to(torch.int64)) - 1
    h = ((x.to(torch.int64) & 0xFFFFFFFF) * hubs_lib.KNUTH) & 0xFFFFFFFF
    return hbase + (h & mask).to(torch.int32)


def alias_propose(
    dg: DeviceCSR, kk: torch.Tensor, u_self: torch.Tensor, cur_rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hub-path proposal: one resolved alias slot per lane.

    Returns ([B] x, [B] w(cur, x)); only meaningful where the row is a hub.
    """
    rows = dg.fetch_edge_slots(dg.rows_edge_base(cur_rows) + kk)
    take_self = u_self < rows[..., hubs_lib.EP_ACCEPT]
    ids = rows.view(torch.int32)
    x = torch.where(
        take_self, ids[..., hubs_lib.EP_NBR_SELF], ids[..., hubs_lib.EP_NBR_ALIAS]
    )
    w = torch.where(
        take_self, rows[..., hubs_lib.EP_WGT_SELF], rows[..., hubs_lib.EP_WGT_ALIAS]
    )
    return x, w


def fused_propose(
    dg: DeviceCSR, u: torch.Tensor, cur_rows: torch.Tensor, use_cdf: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw x ~ w(cur, .) by inverse CDF over the carried row.

    Args:
        u: [B] or [B, 1] uniforms in [0, 1).
        use_cdf: read the packed ``cdf`` channel instead of a prefix sum.

    Returns:
        ([B] int32 x, [B] float32 w(cur, x)).
    """
    wgt = dg.rows_wgt(cur_rows)
    cdf = dg.rows_cdf(cur_rows) if use_cdf else torch.cumsum(wgt, dim=-1)
    c = (cdf < u.reshape(-1, 1) * cdf[:, -1:]).sum(dim=-1)
    c = torch.clamp(c, max=cdf.shape[-1] - 1)[:, None]
    x = dg.rows_nbr(cur_rows).gather(1, c)[:, 0]
    w = wgt.gather(1, c)[:, 0]
    return x, w


def propose(
    dg: DeviceCSR,
    u: torch.Tensor,
    cur_rows: torch.Tensor,
    use_cdf: bool = False,
    kk: Optional[torch.Tensor] = None,
    u_self: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order draw x ~ w(cur, .), hub and capped rows combined.

    ``u`` feeds the capped-row draw; on a hub graph ``kk`` and ``u_self``
    feed the alias draw (JAX: ``k_small`` and ``k_hub`` of ``split(key)``).
    """
    x_s, w_s = fused_propose(dg, u, cur_rows, use_cdf)
    if not dg.has_hubs:
        return x_s, w_s
    x_h, w_h = alias_propose(dg, kk, u_self, cur_rows)
    is_hub = dg.rows_is_hub(cur_rows)
    return torch.where(is_hub, x_h, x_s), torch.where(is_hub, w_h, w_s)


def uniform_propose(
    dg: DeviceCSR, kk: torch.Tensor, cur_rows: torch.Tensor
) -> torch.Tensor:
    """Uniform neighbor draw (FirstOrderUnweighted), hub-aware: slot
    ``kk`` ([B] int32 in ``[0, max(deg, 1))``) of cur's row, or of a hub's
    edges in ``edge_pack``."""
    nbr = dg.rows_nbr(cur_rows)
    # a hub's kk reaches past the row; its pick is discarded below
    x_s = sampling.pick_int_columns(nbr, torch.clamp(kk, max=nbr.shape[1] - 1))
    if not dg.has_hubs:
        return x_s
    rows = dg.fetch_edge_slots(dg.rows_edge_base(cur_rows) + kk)
    x_h = rows.view(torch.int32)[..., hubs_lib.EP_NBR_SELF]
    return torch.where(dg.rows_is_hub(cur_rows), x_h, x_s)


def membership(
    dg: DeviceCSR, x: torch.Tensor, prev_rows: torch.Tensor, mode: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x in nbr(prev), w(prev, x)) per lane: a bucket probe for hub rows,
    a compare against the carried row otherwise.

    ``mode`` "row" / "hub" runs only the carried-row compare / only the
    bucket probe; "auto" computes both and selects per lane.
    """
    if mode == "row" or not dg.has_hubs:
        eq = dg.rows_nbr(prev_rows) == x[..., None]
        pw = dg.rows_wgt(prev_rows)
        return eq.any(dim=-1), torch.where(eq, pw, 0.0).sum(dim=-1)

    hbase, hlog = dg.rows_hash_meta(prev_rows)
    keys, vals = dg.fetch_bucket(hub_bucket(x, hbase, hlog))
    hit = keys == x[..., None]
    found_h = hit.any(dim=-1)
    w_h = torch.where(hit, vals, 0.0).sum(dim=-1)
    if mode == "hub":
        return found_h, w_h

    found_s, w_s = membership(dg, x, prev_rows, mode="row")
    is_hub = dg.rows_is_hub(prev_rows)
    return torch.where(is_hub, found_h, found_s), torch.where(is_hub, w_h, w_s)


def _bias_from_membership(
    dg: DeviceCSR,
    x: torch.Tensor,
    wx: torch.Tensor,
    prev: torch.Tensor,
    cur_rows: torch.Tensor,
    found: torch.Tensor,
    wpx: torch.Tensor,
    p: float,
    q: float,
    extend: bool,
) -> torch.Tensor:
    """Bias factor alpha(x) given the membership test's (found, w(prev,x))."""
    is_prev = x == prev
    inv_q = 1.0 / q
    if not extend:
        return torch.where(is_prev, 1.0 / p, torch.where(found, 1.0, inv_q))

    theta_x = torch.clamp(dg.threshold[x.long()], min=_EPS)
    theta_cur = row_thresholds(dg, cur_rows, dg.gamma)
    if dg.has_hubs:
        theta_cur = torch.where(
            dg.rows_is_hub(cur_rows), dg.rows_hub_threshold(cur_rows), theta_cur
        )

    loose = wpx < theta_x
    is_out = torch.where(found, loose, True) & ~is_prev
    t = torch.where(found & is_out, wpx / theta_x, 0.0)
    alpha_out = inv_q + (1.0 - inv_q) * t
    noisy = wx < theta_cur
    alpha_out = torch.where(noisy, min(1.0, inv_q), alpha_out)
    return torch.where(is_prev, 1.0 / p, torch.where(is_out, alpha_out, 1.0))


def _bias(dg, x, wx, prev, cur_rows, prev_rows, p, q, extend, mode="auto"):
    """node2vec / node2vec+ bias factor alpha(x) for single candidates."""
    found, wpx = membership(dg, x, prev_rows, mode=mode)
    return _bias_from_membership(
        dg, x, wx, prev, cur_rows, found, wpx, p, q, extend
    )


def _propose_trial(dg, d: TrialDraws, prev, cur_rows, theta, wp, use_cdf):
    """One trial's proposal per lane: ([B] x, [B] w(cur, x))."""
    x, wx = propose(dg, d.u_small, cur_rows, use_cdf, d.kk, d.u_self)
    if theta is not None:
        atom = d.u_atom < theta
        x = torch.where(atom, prev, x)
        wx = torch.where(atom, wp, wx)
    return x, wx


def _accept_trial(
    dg, d: TrialDraws, x, wx, prev, cur_rows, prev_rows, p, q, extend,
    alpha_np, use_atom, mode="auto",
):
    """One trial's accept bit per lane for the proposal (x, wx)."""
    alpha = _bias(dg, x, wx, prev, cur_rows, prev_rows, p, q, extend, mode=mode)
    # a true division by a tensor: a Python-scalar divisor may run as a
    # multiply by its reciprocal on CUDA, which differs in the last bit
    accept = alpha / torch.full_like(alpha, alpha_np)
    if use_atom:
        accept = torch.where(x == prev, 1.0, accept)
    return d.u_acc < accept


def _single_trial(
    dg, d: TrialDraws, prev, cur_rows, prev_rows, p, q, extend, alpha_np,
    theta, wp, mode="auto", use_cdf=False,
):
    """One proposal + accept test per lane: ([B] x, [B] ok, [B] w(cur, x))."""
    x, wx = _propose_trial(dg, d, prev, cur_rows, theta, wp, use_cdf)
    ok = _accept_trial(
        dg, d, x, wx, prev, cur_rows, prev_rows, p, q, extend, alpha_np,
        theta is not None, mode,
    )
    return x, ok, wx


def _combine(xs, oks, wxs, force_ok=None):
    """First accepted trial wins; lanes with no accept yet track the
    freshest proposal (the round cap's fallback)."""
    chosen = None
    for x_t, ok_t, wx_t in zip(xs, oks, wxs):
        if force_ok is not None:
            ok_t = ok_t | force_ok
        if chosen is None:
            chosen, got, chosen_w = x_t, ok_t, wx_t
        else:
            chosen = torch.where(got, chosen, x_t)
            chosen_w = torch.where(got, chosen_w, wx_t)
            got = got | ok_t
    return chosen, got, chosen_w


def _trial_block(
    dg, draws: List[TrialDraws], prev, cur_rows, prev_rows, p, q, extend,
    alpha_np, theta=None, wp=None, mode="auto", use_cdf=False, force_ok=None,
):
    """len(draws) iid proposals per lane; returns (first accepted or last,
    any accepted, w(cur, chosen)).

    ``force_ok`` ([B] bool, optional) marks lanes whose trial-1 proposal
    is accepted unconditionally: the queued engine's first-order steps,
    whose atom mass the caller zeroes so the proposal is a pure
    first-order draw.

    ``alpha_np`` bounds the bias over non-return candidates
    (max(1, 1/q)). With the return-edge atom (``theta``/``wp`` set), a
    proposal is the previous node with probability theta and a
    first-order draw otherwise; x == prev always accepts. Without the
    atom, alpha_np must also bound 1/p.
    """
    trials = [
        _single_trial(
            dg, d, prev, cur_rows, prev_rows, p, q, extend, alpha_np,
            theta, wp, mode, use_cdf=use_cdf,
        )
        for d in draws
    ]
    xs, oks, wxs = zip(*trials)
    return _combine(xs, oks, wxs, force_ok)


def _theta_from(graph: DeviceCSR, wp, cur_rows, excess, alpha_np):
    """Return-edge atom mass from w(cur -> prev) and cur's weight sum."""
    wsum = graph.rows_wgt(cur_rows).sum(dim=-1)
    if graph.has_hubs:
        wsum = torch.where(
            graph.rows_is_hub(cur_rows), graph.rows_hub_wsum(cur_rows), wsum
        )
    return wp * excess / (wp * excess + alpha_np * torch.clamp(wsum, min=_EPS))


def _compact_indices(pending: torch.Tensor, s: int):
    """Indices of the first ``s`` pending lanes, in lane order.

    Slot j holds the lane where the running count of pending lanes first
    reaches j + 1 (a ``searchsorted`` over the cumsum: no host sync).
    Slots past the pending count are invalid and clamp to lane B - 1, as
    in the JAX package, whose blocked search returns the same indices.

    Returns (idx [s] int32 clamped in range, valid [s] bool).
    """
    b = pending.shape[0]
    csum = torch.cumsum(pending.to(torch.int32), 0, dtype=torch.int32)
    j = torch.arange(s, dtype=torch.int32, device=pending.device)
    idx = torch.searchsorted(csum, j + 1).to(torch.int32)
    return torch.clamp(idx, max=b - 1), j < csum[-1]


# draws(phase, [S] int32 degree of each compacted lane's cur, trials) ->
# the phase's draws for ``trials`` trials
PhaseDrawFn = Callable[[int, torch.Tensor, int], RoundDraws]


def use_trial_kernels(extend: bool, dg: DeviceCSR) -> bool:
    """The route of every hub trial block: the CUDA trial kernels (on node
    ids) for node2vec on a graph held whole on the card; the plain
    ``_trial_block`` (on gathered rows) for node2vec+, on the CPU, and on
    a row-sharded graph (``dg.loop_sync`` set), whose rows the kernels
    cannot read by node id (the JAX package's rule too)."""
    return not extend and dg.fused.device.type != "cpu" and dg.loop_sync is None


def second_order_sample(
    dg: DeviceCSR,
    draws: PhaseDrawFn,
    cur: torch.Tensor,
    prev: torch.Tensor,
    cur_rows: torch.Tensor,
    prev_rows: torch.Tensor,
    p: float,
    q: float,
    extend: bool,
    active: torch.Tensor,
) -> torch.Tensor:
    """Exact second-order transition draw by rejection, O(1) per trial
    (``pecanpy_tpu/ops/rejection.py:second_order_sample``).

    The pending lanes are split by prev-hubness into a "hub" group (a
    bucket probe decides membership) and a "row" group (a compare against
    prev's row). Each group's first S1 = B / 4 pending lanes run a block
    of ``FIRST_ROUND_TRIALS`` trials (phases 0 and 1); then sweep t runs
    ``SWEEP_TRIALS`` trials over each group's first S2 = B / 32 pending
    lanes (phases 2 + 2t and 3 + 2t) until no lane is pending. On a graph
    without hubs there is one "row" group: phase 0, then 1 + t. Every
    valid lane records its freshest proposal; an accepted lane leaves the
    pending set. The return-edge atom is computed once over the full
    batch. The pending count is read on the host once per sweep, and a
    sweep skips a group that has no pending lane (it would write nothing).
    Each block takes the route of ``use_trial_kernels``: the trial kernels
    pick the membership route per lane, so the group's ``mode`` only
    routes the plain block. The call's sweeps add to the open job's
    counter ``walk.sweeps`` (``utils/trace.py``).

    Args:
        draws: the phases' draws (a ``SamplerDrawStream`` or injected).
        active: [B] bool lanes that need a rejection-path sample.

    Returns [B] int32 samples (valid where active).
    """
    b = cur.shape[0]
    alpha_np = max(1.0, 1.0 / q)  # bound over non-return candidates
    excess = 1.0 / p - alpha_np
    use_atom = excess > 0.0
    if use_atom:
        _, wp_full = membership(dg, prev, cur_rows)
        theta_full = _theta_from(dg, wp_full, cur_rows, excess, alpha_np)
    # slot b of the two buffers takes the writes of invalid slots
    nxt = torch.cat([cur, cur[:1]])
    kernels = use_trial_kernels(extend, dg)
    if kernels:
        from pecanpy_tpu_torch.ops import trialkernel  # imports this module

    def run_phase(pending, phase, s, trials, mode):
        idx, valid = _compact_indices(pending[:b], s)
        il = idx.long()
        theta, wp = (theta_full[il], wp_full[il]) if use_atom else (None, None)
        if kernels:
            d = draws(phase, dg.deg[cur[il].long()], trials)
            x_sub, ok_sub, _ = trialkernel.trial_block_fused(
                dg, d, prev[il], cur[il], p, q, alpha_np, theta, wp
            )
        else:
            rows = cur_rows[il]
            d = draws(phase, dg.rows_degree(rows), trials)
            x_sub, ok_sub, _ = _trial_block(
                dg, d.trials(), prev[il], rows, prev_rows[il], p, q, extend,
                alpha_np, theta, wp, mode=mode,
            )
        nxt[torch.where(valid, idx, b).long()] = x_sub
        pending[torch.where(valid & ok_sub, idx, b).long()] = False

    def with_trash(mask):
        return torch.cat([mask, mask.new_zeros(1)])

    s1 = min(max(-(-b // FIRST_FRACTION), 8), b)
    s2 = min(max(-(-b // COMPACT_FRACTION), 8), b)
    if dg.has_hubs:
        prev_hub = dg.rows_is_hub(prev_rows)
        groups = [(with_trash(active & prev_hub), "hub"), (with_trash(active & ~prev_hub), "row")]
    else:
        groups = [(with_trash(active), "row")]
    n_g = len(groups)
    for g, (pending, mode) in enumerate(groups):
        run_phase(pending, g, s1, FIRST_ROUND_TRIALS, mode)

    t = 0
    while t < SWEEP_CAP:
        counts = torch.stack([pnd.sum(dtype=torch.int32) for pnd, _ in groups])
        if dg.loop_sync is not None:  # every rank runs the same sweeps
            counts = dg.loop_sync(counts)
        with trace.sync("pecanpy.walk.sweep_read"):
            counts = counts.tolist()  # host read
        if not any(counts):
            break
        for g, (pending, mode) in enumerate(groups):
            if counts[g]:
                run_phase(pending, n_g + n_g * t + g, s2, SWEEP_TRIALS, mode)
        t += 1
    trace.count("walk.sweeps", t)
    return nxt[:b]
