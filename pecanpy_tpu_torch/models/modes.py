"""The five walk modes, as step-function factories over the shared engines.

Counterpart of ``pecanpy_tpu/models/modes.py``. ``SparseOTF`` and
``DenseOTF`` differ only in which host container they parse into; both
feed the same fused row layout. Graphs without hubs walk with the scan
engine over the step functions below; the OTF modes, whose ``WalkSpec``
takes the hub engines, walk graphs with hubs with the queued hub engine,
or under ``PECANPY_TPU_AMORTIZED=0`` with the scan engine and the
per-step rejection sampler (``Base._make_walk_runner``).
``FirstOrderUnweighted``, ``PreCompFirstOrder`` and ``PreComp`` always
take the scan engine.

Step functions receive the *pre-gathered fused rows* of the current and
previous nodes (carried by the engine) and never touch the node table;
PreComp's step also reads one row of its per-edge table, which its step
function closes over.
"""
import os

import numpy as np
import torch

from pecanpy_tpu_torch.graph import DenseGraph, SparseGraph
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.models.base import Base, WalkSpec
from pecanpy_tpu_torch.ops import rejection, sampling, transition
from pecanpy_tpu_torch.ops.layout import (
    DeviceCSR,
    build_device_csr,
    device_csr_from_dense,
)
from pecanpy_tpu_torch.utils import trace


class _SparseModeBase(Base, SparseGraph):
    """Modes whose host container is the CSR ``SparseGraph``."""

    def _build_device_graph(self, device=None) -> DeviceCSR:
        deg_max = int(np.diff(self.indptr).max()) if self.num_edges else 0
        return build_device_csr(
            self.indptr,
            self.indices,
            self.data,
            gamma=self.gamma,
            with_thresholds=self.extend,
            with_cdf=self._want_cdf(deg_max),
            degree_cap=self.degree_cap,
            device=device or self.device,
        )


class _DenseModeBase(Base, DenseGraph):
    """Modes whose host container is the dense ``DenseGraph``."""

    def _build_device_graph(self, device=None) -> DeviceCSR:
        dense = np.asarray(self.data)
        nonzero_per_row = (dense != 0).sum(axis=1)
        deg_max = int(nonzero_per_row.max()) if nonzero_per_row.size else 0
        return device_csr_from_dense(
            dense,
            gamma=self.gamma,
            with_thresholds=self.extend,
            with_cdf=self._want_cdf(deg_max),
            degree_cap=self.degree_cap,
            device=device or self.device,
        )


def _pick_kernel(extend: bool):
    """Second-order bias function; gamma rides on the device graph."""
    if extend:
        return transition.node2vec_plus_weights_rows
    return transition.node2vec_weights_rows


def _otf_step_fns(p: float, q: float, extend: bool):
    """On-the-fly transition sampling: bias weights + inverse-CDF draw
    (reference OTF move, ``pecanpy.py:543-559``, batched).

    On a hub graph (the scan engine under ``PECANPY_TPU_AMORTIZED=0``)
    the step functions also take the step's sampler draws: the first step
    draws a hub's alias slot from ``draws(FIRST, deg, 1)``, and a later
    step sends every lane whose cur or prev is a hub through
    ``rejection.second_order_sample``. Every lane still takes the fused
    draw (a hub lane's, on its marker row, is discarded), as in
    ``pecanpy_tpu/models/modes.py:_otf_step_fns``.
    """
    kernel = _pick_kernel(extend)

    def first_fn(dg, u, cur, cur_rows, draws=None):
        if not dg.has_hubs:
            x, _ = rejection.propose(dg, u, cur_rows)
            return x
        d = draws(engine.FIRST, dg.rows_degree(cur_rows), 1).trials()[0]
        x, _ = rejection.propose(dg, u, cur_rows, False, d.kk, d.u_self)
        return x

    def step_fn(dg, u, cur, prev, cur_rows, prev_rows, draws=None):
        weights = kernel(dg, cur_rows, prev_rows, prev, p, q)
        choice = sampling.categorical_rows(u, weights)
        nxt = sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)
        if dg.has_hubs:
            use_rej = dg.rows_is_hub(cur_rows) | dg.rows_is_hub(prev_rows)
            nxt_rej = rejection.second_order_sample(
                dg, draws, cur, prev, cur_rows, prev_rows, p, q, extend, use_rej
            )
            nxt = torch.where(use_rej, nxt_rej, nxt)
        return nxt

    return first_fn, step_fn


def _first_order_fns(move):
    """(first_fn, step_fn) of a first-order mode: both steps ``move``."""

    def first_fn(dg, u, cur, cur_rows):
        return move(dg, u, cur_rows)

    def step_fn(dg, u, cur, prev, cur_rows, prev_rows):
        return move(dg, u, cur_rows)

    return first_fn, step_fn


def first_order_unweighted_fns(p=1.0, q=1.0, extend=False):
    """FirstOrderUnweighted's steps: a uniform slot of the row, or of a
    hub's edges (``p``, ``q`` and ``extend`` play no part)."""

    def move(dg, u, cur_rows):
        kk = rejection.slot_offsets(u[:, 0], dg.rows_degree(cur_rows))
        return rejection.uniform_propose(dg, kk, cur_rows)

    return _first_order_fns(move)


def precomp_first_order_fns(p=1.0, q=1.0, extend=False):
    """PreCompFirstOrder's steps: the row's cdf channel, or a hub's alias
    slot from the step's second and third uniforms (``p``, ``q`` and
    ``extend`` play no part)."""

    def move(dg, u, cur_rows):
        kk = u_self = None
        if dg.has_hubs:
            kk = rejection.slot_offsets(u[:, 1], dg.rows_degree(cur_rows))
            u_self = u[:, 2]
        x, _ = rejection.propose(dg, u[:, :1], cur_rows, True, kk, u_self)
        return x

    return _first_order_fns(move)


class SparseOTF(_SparseModeBase):
    """Compute second-order probabilities on the fly each step (default
    mode; reference ``pecanpy.py:510-561``)."""

    WALK_SPEC = WalkSpec(_otf_step_fns, hub_engine=True)


class DenseOTF(_DenseModeBase):
    """OTF walking from a dense adjacency input (reference
    ``pecanpy.py:564-614``): the same transition law as SparseOTF."""

    WALK_SPEC = SparseOTF.WALK_SPEC


class FirstOrderUnweighted(_SparseModeBase):
    """Uniform neighbor sampling; no probabilities at all (reference
    ``pecanpy.py:293-309``): the next node is a uniform entry of the row,
    of a hub's edges on a hub graph."""

    WALK_SPEC = WalkSpec(first_order_unweighted_fns)


class PreCompFirstOrder(_SparseModeBase):
    """First-order weighted walks from each node's precomputed transition
    CDF (reference ``pecanpy.py:312-361``, per-node alias tables there):
    the CDF is a fused-row channel, so a step is the row gather the
    engine makes anyway plus a compare-reduce. On a hub graph a hub's
    draw comes from its alias slots: the step then draws three uniforms,
    the row's, the slot's and the alias coin's (JAX: ``split(key)``)."""

    _needs_cdf_channel = True
    # replicated only, as in the JAX package's multichip trainer
    WALK_SPEC = WalkSpec(precomp_first_order_fns, hub_draw_width=3, edge=False)


class PreComp(_SparseModeBase):
    """Precomputed second-order transition CDFs for every directed edge.

    Reference ``pecanpy.py:364-507``: one table per directed edge (cur,
    prev), addressed by flat edge id ``indptr[cur] + position of prev in
    cur's row`` (``pecanpy.py:426-436``). Layout as in the JAX package: an
    [E, min(64, width)] f32 table holding, for every edge whose source
    degree fits the row, the full transition CDF out of cur given prev;
    a step is one edge-row gather and a compare-reduce. Edges of wider
    nodes fall back to the on-the-fly bias on the carried rows, drawing
    with the same uniform (the same law, computed instead of looked up).
    Memory is E x w f32 whatever the degree skew, w = min(64, the
    largest degree rounded up to 8, at most ``dpad``): the bias rows
    span that many slots (``transition._active_width``); the guard is
    E * min(64, dpad) < 2^31. The first step (no prev) samples the node's
    first-order CDF channel (``pecanpy.py:412-424``).

    Traced (``utils/trace.py``): the build is the job ``pecanpy.precomp``
    (a span inside a job), which ends when the table is on the card, with
    the counters ``precomp.table_bytes`` and ``precomp.build_slices``;
    each second-order step adds to
    ``walk.precomp_steps``, ``walk.precomp_lane_steps`` (its lanes) and,
    where it runs the wide-degree fallback, ``walk.precomp_fallback_steps``.
    All are host-side counts: none reads the device.
    """

    _needs_cdf_channel = True
    PRECOMP_WIDTH = 64

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # edge-id addressing (indptr[cur] + position) needs full-width
        # fused rows; wide nodes use the OTF fallback instead of hubs
        self.degree_cap = None
        self.edge_cdf = None

    def preprocess_transition_probs(self):
        dg = self.get_device_graph()
        with trace.job("pecanpy.precomp"):
            self.edge_cdf = self._build_edge_cdf(dg)

    def _build_edge_cdf(self, dg: DeviceCSR) -> torch.Tensor:
        w = min(self.PRECOMP_WIDTH, dg.dpad)
        with trace.sync("pecanpy.walk.edges_read"):
            e = int(dg.indptr[-1])
        if e * w >= 2**31:
            raise ValueError(
                f"PreComp's per-edge tables need E * {w} < 2^31 (got E={e}); "
                "use SparseOTF for graphs of this size (the reference's "
                "mode-selection heuristics give the same advice)."
            )
        kernel = _pick_kernel(self.extend)
        p, q = self.p, self.q
        edge_cur, slot = _flat_edge_positions(dg, e)

        def build(lo, hi):
            """CDF rows of edges lo..hi-1: the transition distribution out
            of u given the walker arrived from x, for each edge (u -> x)."""
            cur_rows = dg.gather_rows(edge_cur[lo:hi])
            edge_prev = dg.rows_nbr(cur_rows).gather(1, slot[lo:hi, None])[:, 0]
            prev_rows = dg.gather_rows(edge_prev)
            weights = kernel(dg, cur_rows, prev_rows, edge_prev, p, q)
            cdf = torch.cumsum(weights, dim=-1)
            total = torch.clamp(cdf[:, -1:], min=1e-30)
            # rows of nodes with deg <= w carry their complete CDF in the
            # first w slots (padding saturates at 1.0); wider rows are
            # never read (OTF fallback)
            return torch.clamp(cdf / total, max=1.0)[:, :w]

        # Chunked over edge slices under a transient-bytes budget
        # (``PECANPY_TPU_PRECOMP_BUILD_MB``, default 1024): the one-shot
        # form gathers [E, W] cur and prev rows, tens of GB at the sizes
        # the guard admits. Per-edge rows are independent, so the slices
        # are bit-identical to the one-shot build.
        row_w = dg.fused.shape[1]
        per_edge = (2 * row_w + 2 * dg.dpad + w) * 4
        budget_mb = int(os.environ.get("PECANPY_TPU_PRECOMP_BUILD_MB", "1024"))
        slice_e = max(min(e, (budget_mb << 20) // max(per_edge, 1)), 256)
        parts = [build(lo, min(lo + slice_e, e)) for lo in range(0, max(e, 1), slice_e)]
        edge_cdf = parts[0] if len(parts) == 1 else torch.cat(parts)
        trace.count("precomp.table_bytes", edge_cdf.numel() * edge_cdf.element_size())
        trace.count("precomp.build_slices", len(parts))
        # the build is queued far ahead of the card: wait for it, so that
        # the job's time is the build's and not its dispatch's
        with trace.sync("pecanpy.precomp.ready"):
            if edge_cdf.is_cuda:
                torch.cuda.synchronize(edge_cdf.device)
        return edge_cdf

    def make_step_fns(self):
        kernel = _pick_kernel(self.extend)
        p, q = self.p, self.q
        edge_cdf = self.edge_cdf
        w = edge_cdf.shape[1]
        dg0 = self.get_device_graph()
        # no node wider than the table row: the fallback never applies
        fallback = w < dg0.dpad and dg0.max_degree > w

        def first_fn(dg, u, cur, cur_rows):
            choice = sampling.sample_from_cdf(u, dg.rows_cdf(cur_rows))
            return sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)

        def step_fn(dg, u, cur, prev, cur_rows, prev_rows):
            trace.count("walk.precomp_steps")
            trace.count("walk.precomp_lane_steps", cur.shape[0])
            cur_nbr = dg.rows_nbr(cur_rows)
            pos = transition.row_searchsorted(cur_nbr, prev[:, None])[:, 0]
            pos = torch.clamp(pos, max=cur_nbr.shape[1] - 1)
            # clamped into the table, as the JAX gather clamps: a dead
            # walker or a prev missing from cur's row reads some edge's
            # row, and the engine discards what it picks
            edge_row = torch.clamp(dg.indptr[cur.long()] + pos, 0, edge_cdf.shape[0] - 1)
            choice = sampling.sample_from_cdf(u, edge_cdf[edge_row.long()])
            if fallback:
                # wide-degree fallback: the same law, computed on the fly
                # from the carried rows with the same uniform
                trace.count("walk.precomp_fallback_steps")
                weights = kernel(dg, cur_rows, prev_rows, prev, p, q)
                choice_otf = sampling.categorical_rows(u, weights)
                deg = transition.row_degrees(dg, cur_rows)
                choice = torch.where(deg > w, choice_otf, choice)
            return sampling.pick_int_columns(cur_nbr, choice)

        return first_fn, step_fn


def _flat_edge_positions(dg: DeviceCSR, e: int):
    """Per-edge (source node, slot of the edge in the node's row), both
    [E] int64, in CSR edge order; ``e`` is the edge count, already read."""
    dev = dg.fused.device
    edge_cur = torch.repeat_interleave(
        torch.arange(dg.num_nodes, device=dev), dg.deg.long(), output_size=e
    )
    slot = torch.arange(e, device=dev) - dg.indptr.long()[edge_cur]
    return edge_cur, slot
