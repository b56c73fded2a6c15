"""Fused-row device layout for the walk engine.

Counterpart of ``pecanpy_tpu/ops/layout.py``, kept bit for bit: every
walk step needs one node's neighbor ids, edge weights and (node2vec+)
neighbor thresholds, and all of them live in ONE fixed-width float32 row,
channel-packed:

    fused[i] = [ nbr (int32 bitcast) | wgt | thr? ]    width = C * dpad

so a batch of B walkers fetches all per-node state with one row gather.

Layout invariants (the transition functions rely on all of these):

* ``nbr`` slots ``[0, deg)`` list neighbors in ascending order, stored as
  int32 bit patterns inside float32 lanes. Small ids are denormal floats:
  they are only ever copied (gathered, sliced) and decoded with
  ``.view(torch.int32)``, never touched by float arithmetic, which may
  flush denormals to zero.
* nbr padding is the sentinel ``num_nodes`` (greater than every real id,
  so padded rows stay sorted and never collide in membership tests).
* ``wgt`` is 0 at padded slots, so padding carries zero probability.
* ``thr`` (node2vec+ only) holds the noise threshold of the neighbor in
  each slot; padding 1.0.
* ``dpad`` is the true max degree rounded up to 64 lanes.

Graphs whose max degree exceeds ``degree_cap`` (power-law hubs) need the
JAX package's hub structures and rejection sampler, which are not ported
yet: building such a graph raises ``NotImplementedError``.
"""
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

LANE = 64  # fused channel width granularity (f32 lanes)

# Nodes above this degree are hubs (``pecanpy_tpu/ops/layout.py``).
DEFAULT_DEGREE_CAP = 128

HUB_PATH_ROADMAP = (
    "the hub path (rejection walkers and the trial kernels) is not ported "
    "yet: see ROADMAP.md, 'Modules to port', slice C"
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Channel-packed padded neighbor table on one device.

    Attributes:
        fused: [N, C * dpad] float32 fused rows (C = number of channels).
        deg: [N] int32 true degree of each node.
        threshold: [N + 1] float32 node2vec+ noise thresholds; the
            sentinel slot holds 1.0.
        indptr: [N + 1] int32 row offsets of the flat CSR.
        channels: channel names in row order, e.g. ("nbr", "wgt").
        dpad: padded slots per channel (multiple of 64).
        max_degree: true max degree.
        gamma: node2vec+ noise-threshold std multiplier.
        symmetric: the CSR equals its transpose (weights bit-exact).
    """

    fused: torch.Tensor
    deg: torch.Tensor
    threshold: torch.Tensor
    indptr: torch.Tensor
    channels: Tuple[str, ...] = ("nbr", "wgt")
    dpad: int = LANE
    max_degree: int = 0
    gamma: float = 0.0
    symmetric: bool = False

    @property
    def num_nodes(self) -> int:
        return self.fused.shape[0]

    def channel(self, rows: torch.Tensor, name: str) -> torch.Tensor:
        """Slice channel ``name`` out of gathered fused rows [B, C * dpad]."""
        c = self.channels.index(name)
        return rows[..., c * self.dpad : (c + 1) * self.dpad]

    def rows_nbr(self, rows: torch.Tensor) -> torch.Tensor:
        """[B, dpad] int32 neighbor ids from gathered rows (a bit view)."""
        return self.channel(rows, "nbr").view(torch.int32)

    def rows_wgt(self, rows: torch.Tensor) -> torch.Tensor:
        return self.channel(rows, "wgt")

    def rows_thr(self, rows: torch.Tensor) -> torch.Tensor:
        """Per-slot neighbor noise thresholds (the ``thr`` channel, packed
        for node2vec+ graphs)."""
        return self.channel(rows, "thr")

    def gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Fetch fused rows for a batch of node indices (the hot gather)."""
        return self.fused[idx.long()]

    @property
    def nbr(self) -> torch.Tensor:
        """[N, dpad] int32 neighbor matrix view."""
        return self.rows_nbr(self.fused)


def _segment_stats(
    indptr: np.ndarray, data: np.ndarray, gamma: float
) -> np.ndarray:
    """Per-row mean + gamma * std (population std), clipped at 0.

    Copied from ``pecanpy_tpu/ops/layout.py:_segment_stats``. Rows with no
    edges get threshold 0 (never consulted: walkers stop there).
    """
    deg = np.diff(indptr).astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(data, dtype=np.float64)])
    csum2 = np.concatenate([[0.0], np.cumsum(data.astype(np.float64) ** 2)])
    row_sum = csum[indptr[1:]] - csum[indptr[:-1]]
    row_sum2 = csum2[indptr[1:]] - csum2[indptr[:-1]]
    safe_deg = np.maximum(deg, 1)
    mean = row_sum / safe_deg
    var = np.maximum(row_sum2 / safe_deg - mean**2, 0.0)
    thresholds = mean + gamma * np.sqrt(var)
    thresholds[deg == 0] = 0.0
    return np.maximum(thresholds, 0.0).astype(np.float32)


def edges_symmetric(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray
) -> bool:
    """True iff the CSR equals its transpose (weights bit-exact).

    Copied from ``pecanpy_tpu/ops/layout.py:edges_symmetric``.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if indices.size == 0:
        return True
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(indptr.size - 1), deg)
    fwd = np.lexsort((indices, rows))
    rev = np.lexsort((rows, indices))
    return bool(
        np.array_equal(rows[fwd], indices[rev])
        and np.array_equal(indices[fwd], rows[rev])
        and np.array_equal(data[fwd], data[rev])
    )


def pack_fused_host(channels_data) -> np.ndarray:
    """Channel-pack host [N, dpad] arrays into one [N, C * dpad] f32 table.

    int32 arrays are bitcast into the float32 row, float arrays are cast
    (copied from ``pecanpy_tpu/ops/layout.py:pack_fused_host``).
    """
    parts = []
    for _, arr in channels_data:
        if arr.dtype == np.int32:
            parts.append(arr.view(np.float32))
        else:
            parts.append(np.ascontiguousarray(arr, dtype=np.float32))
    return np.concatenate(parts, axis=1)


def build_device_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    gamma: float = 0.0,
    max_degree: Optional[int] = None,
    with_thresholds: bool = False,
    degree_cap: Optional[int] = DEFAULT_DEGREE_CAP,
    symmetric: Optional[bool] = None,
    device="cuda",
) -> DeviceCSR:
    """Pack a host CSR triple into the fused layout on ``device``.

    Args:
        indptr: [N+1] row offsets (any integer dtype).
        indices: [E] neighbor indices, ascending within each row.
        data: [E] positive edge weights.
        gamma: node2vec+ noise-threshold std multiplier.
        max_degree: optional fused row-width override.
        with_thresholds: add the per-neighbor threshold channel (node2vec+).
        degree_cap: a graph whose max degree exceeds this has hubs, and
            raises ``NotImplementedError`` (the hub path is not ported).
            None pads every row to the true max degree, under the same
            byte budget as the JAX package.
        symmetric: declare the graph symmetric (True), directed (False),
            or unknown (None: detected with ``edges_symmetric``).
        device: where the tables live.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data, dtype=np.float32)
    num_nodes = indptr.size - 1
    deg = np.diff(indptr).astype(np.int32)
    true_max = int(deg.max()) if deg.size and deg.max() > 0 else 1
    if symmetric is None:
        symmetric = edges_symmetric(indptr, indices, data)

    if degree_cap is not None and true_max > degree_cap:
        raise NotImplementedError(
            f"max degree {true_max} exceeds degree_cap={degree_cap}: "
            f"{HUB_PATH_ROADMAP}"
        )
    width = true_max
    if max_degree is not None:
        if max_degree < width:
            raise ValueError(
                f"max_degree={max_degree} is below the fused width {width}"
            )
        width = max_degree
    dpad = _round_up(max(width, 1), LANE)

    if degree_cap is None:
        # same hard byte budget as the JAX package: one skewed node pads
        # every row to its degree
        n_channels = 2 + int(with_thresholds)
        fused_bytes = num_nodes * dpad * n_channels * 4
        budget = (
            int(os.environ.get("PECANPY_TPU_FUSED_BUDGET_MB", "8192"))
            * (1 << 20)
        )
        if fused_bytes > budget:
            raise ValueError(
                f"uncapped fused layout needs {num_nodes} nodes x {dpad} "
                f"slots x {n_channels} channels = {fused_bytes / 2**30:.1f} "
                f"GiB (> {budget / 2**30:.1f} GiB budget, "
                "PECANPY_TPU_FUSED_BUDGET_MB). The max degree "
                f"({true_max}) is too skewed for degree_cap=None."
            )

    thresholds = np.concatenate(
        [_segment_stats(indptr, data, gamma), np.ones(1, dtype=np.float32)]
    )

    nbr_p = np.full((num_nodes, dpad), num_nodes, dtype=np.int32)
    wgt_p = np.zeros((num_nodes, dpad), dtype=np.float32)
    if indices.size:
        row_of_edge = np.repeat(np.arange(num_nodes), deg)
        col_of_edge = np.arange(indices.size) - indptr[row_of_edge]
        nbr_p[row_of_edge, col_of_edge] = indices
        wgt_p[row_of_edge, col_of_edge] = data

    channels_data = [("nbr", nbr_p), ("wgt", wgt_p)]
    if with_thresholds:
        thr_p = thresholds[np.minimum(nbr_p, num_nodes)]
        channels_data.append(("thr", thr_p))

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return DeviceCSR(
        fused=put(pack_fused_host(channels_data)),
        deg=put(deg),
        threshold=put(thresholds),
        indptr=put(indptr.astype(np.int32)),
        channels=tuple(name for name, _ in channels_data),
        dpad=dpad,
        max_degree=true_max,
        gamma=gamma,
        symmetric=bool(symmetric),
    )


def device_csr_from_dense(
    dense: np.ndarray,
    gamma: float = 0.0,
    max_degree: Optional[int] = None,
    with_thresholds: bool = False,
    degree_cap: Optional[int] = DEFAULT_DEGREE_CAP,
    symmetric: Optional[bool] = None,
    device="cuda",
) -> DeviceCSR:
    """Build the fused layout from a dense adjacency matrix.

    Row order (ascending neighbor index) matches ``np.nonzero``.
    """
    dense = np.asarray(dense)
    if symmetric is None:
        symmetric = bool(np.array_equal(dense, dense.T))
    rows, cols = np.nonzero(dense)
    deg = np.bincount(rows, minlength=dense.shape[0])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return build_device_csr(
        indptr,
        cols,
        dense[rows, cols],
        gamma=gamma,
        max_degree=max_degree,
        with_thresholds=with_thresholds,
        degree_cap=degree_cap,
        symmetric=symmetric,
        device=device,
    )


def from_numpy(host, device="cpu") -> DeviceCSR:
    """The port's ``DeviceCSR`` from a JAX-package one with numpy leaves.

    ``host`` is any object with the JAX ``DeviceCSR`` attributes, e.g.
    ``jax.tree.map(np.asarray, jax_csr)``. Only graphs without hubs carry
    over. A channel the port does not read (the PreComp ``cdf``) raises.
    """
    if getattr(host, "has_hubs", False):
        raise NotImplementedError(HUB_PATH_ROADMAP)
    channels = tuple(host.channels)
    unknown = set(channels) - {"nbr", "wgt", "thr"}
    if unknown:
        raise NotImplementedError(
            f"fused channels {sorted(unknown)} belong to modes that are not "
            "ported yet (ROADMAP.md, 'Modules to port')"
        )

    def put(arr):
        return torch.from_numpy(np.array(arr)).to(device)

    return DeviceCSR(
        fused=put(host.fused),
        deg=put(host.deg),
        threshold=put(host.threshold),
        indptr=put(host.indptr),
        channels=channels,
        dpad=int(host.dpad),
        max_degree=int(host.max_degree),
        gamma=float(host.gamma),
        symmetric=bool(host.symmetric),
    )
