"""Batched transition weights over fused rows.

Counterpart of ``pecanpy_tpu/ops/transition.py``. Each function maps a
batch of walker states to *unnormalized* transition weights over the
padded neighbor slots of the current nodes:

    cur_rows [B, W], prev_rows [B, W]  ->  [B, d] weights

where the rows were gathered by the walk engine and carried from the last
step, so a second-order step reads the node table only once. Inverse-CDF
sampling consumes unnormalized weights directly.

Membership of each candidate in prev's row is an all-pairs equality mask
``[B, d, d]`` over the two carried rows, exactly as in the JAX package.
Padded slots carry weight 0 and the sentinel id, so whatever bias factor
they pick up, their probability stays 0.
"""
from typing import Optional

import torch

from pecanpy_tpu_torch.ops.layout import DeviceCSR

_EPS = 1e-30


def _active_width(graph: DeviceCSR) -> int:
    """Slots that can hold real neighbors: the true max degree rounded up
    to 8, at most ``dpad`` (the membership test is O(width^2))."""
    width = -(-min(graph.max_degree, graph.dpad) // 8) * 8
    return min(max(width, 8), graph.dpad)


def row_searchsorted(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``searchsorted``: first index where a[b, i] >= v[b, j].

    Args:
        a: [B, D] rows, each sorted ascending.
        v: [B, K] query values of ``a``'s dtype.

    Returns:
        [B, K] int32 insertion positions in [0, D].
    """
    return torch.searchsorted(a.contiguous(), v.contiguous(), out_int32=True)


def _locate_in_prev(cur_nbr: torch.Tensor, prev_nbr: torch.Tensor,
                    prev_wgt=None):
    """For each candidate x in cur's row, look x up in prev's row.

    Returns:
        found: [B, d] bool, x is a neighbor of prev.
        prev_wgt_of: [B, d] float32 w(prev, x), 0 where not found, or
            None when ``prev_wgt`` is None (plain node2vec needs only
            membership).
    """
    eq = cur_nbr[:, :, None] == prev_nbr[:, None, :]  # [B, d, d]
    found = eq.any(dim=-1)
    if prev_wgt is None:
        return found, None
    prev_wgt_of = torch.where(eq, prev_wgt[:, None, :], 0.0).sum(dim=-1)
    return found, prev_wgt_of


def row_degrees(graph: DeviceCSR, rows: torch.Tensor) -> torch.Tensor:
    """[B] int32 true degrees, counted from the nbr channel sentinels."""
    return (graph.rows_nbr(rows) != graph.num_nodes).sum(dim=-1, dtype=torch.int32)


def row_thresholds(
    graph: DeviceCSR, rows: torch.Tensor, gamma: float
) -> torch.Tensor:
    """[B] noise threshold of each row's node, recomputed from its weights
    (population mean + gamma * std over the edge weights, clipped at 0)."""
    w = graph.rows_wgt(rows)
    deg = torch.clamp((w > 0).to(torch.float32).sum(dim=-1), min=1.0)
    mean = w.sum(dim=-1) / deg
    var = torch.clamp((w * w).sum(dim=-1) / deg - mean * mean, min=0.0)
    return torch.clamp(mean + gamma * torch.sqrt(var), min=0.0)


def first_order_weights_rows(graph: DeviceCSR, rows: torch.Tensor) -> torch.Tensor:
    """First-order transition weights: the raw edge weights w(cur, .)."""
    return graph.rows_wgt(rows)


def node2vec_weights_rows(
    graph: DeviceCSR,
    cur_rows: torch.Tensor,
    prev_rows: torch.Tensor,
    prev: torch.Tensor,
    p: float,
    q: float,
) -> torch.Tensor:
    """Second-order node2vec biased weights from fused rows.

    Neighbors of cur that are neither neighbors of prev nor prev itself
    are "out" edges and divide by q; the return edge divides by p; common
    neighbors keep their weight.
    """
    d = _active_width(graph)
    cur_nbr = graph.rows_nbr(cur_rows)[:, :d]
    w = graph.rows_wgt(cur_rows)[:, :d]
    prev_nbr = graph.rows_nbr(prev_rows)[:, :d]
    found, _ = _locate_in_prev(cur_nbr, prev_nbr)
    is_prev = cur_nbr == prev[:, None]
    is_out = ~found & ~is_prev
    w = w * torch.where(is_out, 1.0 / q, 1.0)
    w = w * torch.where(is_prev, 1.0 / p, 1.0)
    return w


def node2vec_plus_weights_rows(
    graph: DeviceCSR,
    cur_rows: torch.Tensor,
    prev_rows: torch.Tensor,
    prev: torch.Tensor,
    p: float,
    q: float,
    gamma: Optional[float] = None,
) -> torch.Tensor:
    """Second-order node2vec+ biased weights (the ``extend`` mode).

    * candidate x is an out edge iff it is not a neighbor of prev, or
      w(prev, x) < threshold[x];
    * out edges get ``alpha = 1/q + (1 - 1/q) * t`` with
      ``t = w(prev, x) / threshold[x]`` (0 for non-neighbors of prev);
    * out edges with w(cur, x) < threshold[cur] get ``min(1, 1/q)``;
    * the return edge divides by p.
    """
    d = _active_width(graph)
    cur_nbr = graph.rows_nbr(cur_rows)[:, :d]
    w = graph.rows_wgt(cur_rows)[:, :d]
    prev_nbr = graph.rows_nbr(prev_rows)[:, :d]
    found, prev_wgt_of = _locate_in_prev(
        cur_nbr, prev_nbr, graph.rows_wgt(prev_rows)[:, :d]
    )
    is_prev = cur_nbr == prev[:, None]

    if gamma is None:
        gamma = graph.gamma
    theta_x = graph.rows_thr(cur_rows)[:, :d]  # padded slots are 1.0
    theta_cur = row_thresholds(graph, cur_rows, gamma)[:, None]  # [B, 1]

    loose = prev_wgt_of < theta_x
    is_out = torch.where(found, loose, True) & ~is_prev

    t = torch.where(
        found & is_out, prev_wgt_of / torch.clamp(theta_x, min=_EPS), 0.0
    )
    inv_q = 1.0 / q
    alpha = inv_q + (1.0 - inv_q) * t
    noisy = w < theta_cur
    alpha = torch.where(noisy, min(1.0, inv_q), alpha)

    w = w * torch.where(is_out, alpha, 1.0)
    w = w * torch.where(is_prev, 1.0 / p, 1.0)
    return w


def node2vec_pp_weights_rows(
    graph: DeviceCSR,
    cur_rows: torch.Tensor,
    prev_rows: torch.Tensor,
    prev: torch.Tensor,
    p: float,
    q: float,
) -> torch.Tensor:
    """Experimental node2vec++ continuous bias weights from fused rows.

    Out edges are candidates with w(prev, x) < threshold[x] (prev
    excluded); the interpolant t flips to ``1 - t`` when q < 1, and the
    bias is ``alpha = t * b / (1 + (b - 1)) * |1 - 1/q| + min(1, 1/q)``
    with ``b = w(cur, x) / threshold[x]`` (the b-terms cancel; kept as the
    JAX package writes them, for parity).
    """
    d = _active_width(graph)
    cur_nbr = graph.rows_nbr(cur_rows)[:, :d]
    w = graph.rows_wgt(cur_rows)[:, :d]
    prev_nbr = graph.rows_nbr(prev_rows)[:, :d]
    _, prev_wgt_of = _locate_in_prev(
        cur_nbr, prev_nbr, graph.rows_wgt(prev_rows)[:, :d]
    )
    is_prev = cur_nbr == prev[:, None]

    theta_x = torch.clamp(graph.rows_thr(cur_rows)[:, :d], min=_EPS)
    is_out = (prev_wgt_of < theta_x) & ~is_prev

    t = torch.clamp(prev_wgt_of / theta_x, 0.0, 1.0)
    if q < 1.0:
        t = 1.0 - t
    b = w / theta_x

    inv_q = 1.0 / q
    scale = abs(1.0 - inv_q)
    offset = min(1.0, inv_q)
    # 1 + (b - 1) == b; guard against b == 0 on padded zero-weight slots
    alpha = t * b / torch.clamp(1.0 + (b - 1.0), min=_EPS) * scale + offset

    w = w * torch.where(is_out, alpha, 1.0)
    w = w * torch.where(is_prev, 1.0 / p, 1.0)
    return w


# -- index-taking wrappers (tests / scalar-compat paths; not walk-hot) -------
# (``pecanpy_tpu/ops/transition.py:264-304``)


def first_order_weights(graph: DeviceCSR, cur: torch.Tensor) -> torch.Tensor:
    """Gather-then-compute wrapper around ``first_order_weights_rows``."""
    return first_order_weights_rows(graph, graph.gather_rows(cur))


def node2vec_weights(
    graph: DeviceCSR, cur: torch.Tensor, prev: torch.Tensor, p: float, q: float
) -> torch.Tensor:
    """Gather-then-compute wrapper around ``node2vec_weights_rows``."""
    return node2vec_weights_rows(
        graph, graph.gather_rows(cur), graph.gather_rows(prev), prev, p, q
    )


def node2vec_plus_weights(
    graph: DeviceCSR,
    cur: torch.Tensor,
    prev: torch.Tensor,
    p: float,
    q: float,
    gamma: Optional[float] = None,
) -> torch.Tensor:
    """Gather-then-compute wrapper around ``node2vec_plus_weights_rows``."""
    return node2vec_plus_weights_rows(
        graph, graph.gather_rows(cur), graph.gather_rows(prev), prev, p, q, gamma
    )


def node2vec_pp_weights(
    graph: DeviceCSR, cur: torch.Tensor, prev: torch.Tensor, p: float, q: float
) -> torch.Tensor:
    """Gather-then-compute wrapper around ``node2vec_pp_weights_rows``."""
    return node2vec_pp_weights_rows(
        graph, graph.gather_rows(cur), graph.gather_rows(prev), prev, p, q
    )
