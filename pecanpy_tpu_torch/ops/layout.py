"""Fused-row device layout for the walk engines.

Counterpart of ``pecanpy_tpu/ops/layout.py``, kept bit for bit: every
walk step needs one node's neighbor ids, edge weights and (node2vec+)
neighbor thresholds, and all of them live in ONE fixed-width float32 row,
channel-packed:

    fused[i] = [ nbr (int32 bitcast) | wgt | thr? | cdf? ]  width = C * dpad

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
* ``cdf`` (hub graphs, within a memory budget) holds the normalized
  inclusive first-order CDF of the row; padding 1.0.
* ``dpad`` is the fused width rounded up to 64 lanes.

Degree skew: rows are padded to ``min(max_degree, degree_cap)``. Nodes
above the cap (power-law hubs) store a 4-slot marker instead
(``ops/hubs.py``) and are served by two flat tables, ``edge_pack``
(resolved alias slots) and ``hbuckets`` (neighbor hash buckets), which
drive the exact rejection sampler of ``ops/rejection.py``.
"""
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from pecanpy_tpu_torch.ops import hubs as hubs_lib
from pecanpy_tpu_torch.utils import trace

LANE = 64  # fused channel width granularity (f32 lanes)

# Nodes above this degree are hubs (``pecanpy_tpu/ops/layout.py``).
DEFAULT_DEGREE_CAP = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# Hub-table row shapes (``pecanpy_tpu/ops/layout.py:69-90``): both tables
# are stored as 64-lane super-rows, 8 alias slots (8 lanes each) or 4 hash
# buckets (8 key lanes + 8 value lanes) per stored row, padded to a whole
# super-row at the end. The port keeps the storage so that JAX layouts
# carry across bit for bit; its accessors and kernels address logical
# rows of the flat table directly.
HB_WIDTH = 2 * hubs_lib.BUCKET_WIDTH  # 8 key lanes (int32 bitcast) + 8 vals
SUPER_W = 64  # stored row width of both hub tables
EP_SUPER = SUPER_W // hubs_lib.EP_WIDTH  # alias slots per stored row (8)
HB_SUPER = SUPER_W // HB_WIDTH  # hash buckets per stored row (4)


def _pack_super(rows: np.ndarray) -> np.ndarray:
    """Host-side reshape of [R, w] logical rows into [*, 64] super-rows."""
    r, w = rows.shape
    per = SUPER_W // w
    pad = (-r) % per
    if pad:
        rows = np.pad(rows, ((0, pad), (0, 0)))
    return rows.reshape(-1, SUPER_W)


def _empty_table():
    return torch.empty((0, SUPER_W), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Channel-packed padded neighbor table on one device.

    Attributes:
        fused: [N, C * dpad] float32 fused rows (C = number of channels).
        deg: [N] int32 true degree of each node.
        threshold: [N + 1] float32 node2vec+ noise thresholds; the
            sentinel slot holds 1.0.
        indptr: [N + 1] int32 row offsets of the flat CSR.
        edge_pack: [*, 64] float32 alias-slot super-rows of the hub edges
            (empty without hubs; ``ops/hubs.py`` has the slot layout).
        hbuckets: [*, 64] float32 hash-bucket super-rows of the hubs'
            neighbors (empty without hubs).
        channels: channel names in row order, e.g. ("nbr", "wgt").
        dpad: padded slots per channel (multiple of 64).
        max_degree: true max degree.
        gamma: node2vec+ noise-threshold std multiplier.
        has_hubs: some node's degree exceeds the cap (its row is a marker).
        symmetric: the CSR equals its transpose (weights bit-exact); lets
            the hub walkers reuse an accepted proposal's weight as the
            next return-edge weight. False is always safe.
        hub_frac: share of edges on hub nodes, rounded to 0.01.
    """

    fused: torch.Tensor
    deg: torch.Tensor
    threshold: torch.Tensor
    indptr: torch.Tensor
    edge_pack: torch.Tensor = dataclasses.field(default_factory=_empty_table)
    hbuckets: torch.Tensor = dataclasses.field(default_factory=_empty_table)
    channels: Tuple[str, ...] = ("nbr", "wgt")
    dpad: int = LANE
    max_degree: int = 0
    gamma: float = 0.0
    has_hubs: bool = False
    symmetric: bool = False
    hub_frac: float = 0.0

    @property
    def num_nodes(self) -> int:
        return self.fused.shape[0]

    @property
    def loop_sync(self):
        """None: a local graph, whose walkers run their own loop counts.
        A row-sharded graph (``parallel/distgraph.py``) returns the sum of a
        count over its ranks, so that every rank runs the same rounds and
        the same collective fetches (JAX: ``loop_sync_axis``)."""
        return None

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

    def rows_cdf(self, rows: torch.Tensor) -> torch.Tensor:
        return self.channel(rows, "cdf")

    def gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Fetch fused rows for a batch of node indices (the hot gather)."""
        return self.fused[idx.long()]

    # -- hub-row decoding (see ops/hubs.py for the encoding) ----------------

    def rows_is_hub(self, rows: torch.Tensor) -> torch.Tensor:
        """[B] bool: the row belongs to a hub (degree > degree_cap)."""
        return self.rows_nbr(rows)[:, 0] > self.num_nodes

    def rows_degree(self, rows: torch.Tensor) -> torch.Tensor:
        """[B] int32 true degree, decoding hub markers."""
        nbr = self.rows_nbr(rows)
        counted = (nbr != self.num_nodes).sum(dim=-1, dtype=torch.int32)
        hub_deg = nbr[:, 0] - (self.num_nodes + 1)
        return torch.where(nbr[:, 0] > self.num_nodes, hub_deg, counted)

    def rows_edge_base(self, rows: torch.Tensor) -> torch.Tensor:
        """[B] int32 base row into the logical edge_pack (hub rows only)."""
        return self.rows_nbr(rows)[:, 1]

    def rows_hash_meta(self, rows: torch.Tensor):
        """[B] (base bucket row, log2 bucket count) of the hub hashes."""
        nbr = self.rows_nbr(rows)
        return nbr[:, 2], nbr[:, 3]

    def rows_hub_threshold(self, rows: torch.Tensor) -> torch.Tensor:
        """[B] noise threshold stored in hub rows (wgt channel slot 0)."""
        return self.rows_wgt(rows)[:, 0]

    def rows_hub_wsum(self, rows: torch.Tensor) -> torch.Tensor:
        """[B] total edge weight stored in hub rows (wgt channel slot 1)."""
        return self.rows_wgt(rows)[:, 1]

    # -- hub-table lookups ----------------------------------------------------

    def _fetch_ep_super(self, row: torch.Tensor) -> torch.Tensor:
        """[..., 64] edge_pack super-rows, index clipped into the table
        (as the JAX package clips: non-hub lanes compute garbage slots)."""
        hi = max(self.edge_pack.shape[0] - 1, 0)
        return self.edge_pack[torch.clamp(row, 0, hi).long()]

    def _fetch_hb_super(self, row: torch.Tensor) -> torch.Tensor:
        """[..., 64] hbuckets super-rows, index clipped into the table."""
        hi = max(self.hbuckets.shape[0] - 1, 0)
        return self.hbuckets[torch.clamp(row, 0, hi).long()]

    @staticmethod
    def _sub_row(sup: torch.Tensor, sub: torch.Tensor, per: int) -> torch.Tensor:
        """Sub-row ``sub`` of each [..., 64] super-row, as int32 bits."""
        width = SUPER_W // per
        rows = sup.view(torch.int32).reshape(*sup.shape[:-1], per, width)
        idx = sub.long()[..., None, None].expand(*sub.shape, 1, width)
        return rows.gather(-2, idx).squeeze(-2)

    def fetch_edge_slots(self, slot: torch.Tensor) -> torch.Tensor:
        """[..., EP_WIDTH] resolved alias slot rows by global slot index."""
        sup = self._fetch_ep_super(torch.div(slot, EP_SUPER, rounding_mode="floor"))
        return self._sub_row(sup, torch.remainder(slot, EP_SUPER), EP_SUPER).view(
            torch.float32
        )

    def fetch_bucket(self, bucket: torch.Tensor):
        """(keys [..., 8] int32, vals [..., 8] f32) of one hash bucket."""
        sup = self._fetch_hb_super(torch.div(bucket, HB_SUPER, rounding_mode="floor"))
        row_i = self._sub_row(sup, torch.remainder(bucket, HB_SUPER), HB_SUPER)
        w = hubs_lib.BUCKET_WIDTH
        return row_i[..., :w], row_i[..., w:].contiguous().view(torch.float32)

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
    with_cdf: bool = False,
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
        with_cdf: add the per-node first-order CDF channel.
        degree_cap: nodes above this degree become hubs, served by the
            flat hub tables and rejection sampling (``ops/hubs.py``).
            None pads every row to the true max degree, under the same
            byte budget as the JAX package.
        symmetric: declare the graph symmetric (True), directed (False),
            or unknown (None: detected with ``edges_symmetric``).
        device: where the tables live.

    Spans (``utils/trace.py``): ``pecanpy.layout.host_csr`` (the symmetry
    check, thresholds and padded rows), ``pecanpy.layout.hub_tables``,
    ``pecanpy.layout.pack`` (the channels into one table) and
    ``pecanpy.layout.upload`` (each table's copy a sync).
    """
    with trace.span("pecanpy.layout.host_csr"):
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        data = np.asarray(data, dtype=np.float32)
        num_nodes = indptr.size - 1
        deg = np.diff(indptr).astype(np.int32)
        true_max = int(deg.max()) if deg.size and deg.max() > 0 else 1
        if symmetric is None:
            symmetric = edges_symmetric(indptr, indices, data)

        has_hubs = degree_cap is not None and true_max > degree_cap
        width = min(true_max, degree_cap) if has_hubs else true_max
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
            n_channels = 2 + int(with_thresholds) + int(with_cdf)
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
                    f"({true_max}) is too skewed for degree_cap=None: set a "
                    "degree_cap."
                )

        thresholds = np.concatenate(
            [_segment_stats(indptr, data, gamma), np.ones(1, dtype=np.float32)]
        )

        nbr_p = np.full((num_nodes, dpad), num_nodes, dtype=np.int32)
        wgt_p = np.zeros((num_nodes, dpad), dtype=np.float32)
        is_hub_node = deg > degree_cap if has_hubs else np.zeros(num_nodes, bool)
        if indices.size:
            row_of_edge = np.repeat(np.arange(num_nodes), deg)
            col_of_edge = np.arange(indices.size) - indptr[row_of_edge]
            keep = ~is_hub_node[row_of_edge]
            nbr_p[row_of_edge[keep], col_of_edge[keep]] = indices[keep]
            wgt_p[row_of_edge[keep], col_of_edge[keep]] = data[keep]

    if has_hubs:
        with trace.span("pecanpy.layout.hub_tables"):
            hub_ids = np.nonzero(is_hub_node)[0]
            hub_edges = int(deg[is_hub_node].astype(np.int64).sum())
            hub_frac = round(hub_edges / max(int(indptr[-1]), 1), 2)
            (
                edge_pack,
                hub_base,
                hkey8,
                hval8,
                bucket_base,
                bucket_log,
            ) = hubs_lib.build_hub_structures(indptr, indices, data, hub_ids)
            # marker encoding (see ops/hubs.py HUB_MARKER_SLOTS)
            nbr_p[hub_ids, 0] = num_nodes + 1 + deg[hub_ids]
            nbr_p[hub_ids, 1] = hub_base
            nbr_p[hub_ids, 2] = bucket_base
            nbr_p[hub_ids, 3] = bucket_log
            wgt_p[hub_ids, 0] = thresholds[hub_ids]
            csum = np.concatenate([[0.0], np.cumsum(data, dtype=np.float64)])
            wgt_p[hub_ids, 1] = (
                csum[indptr[hub_ids + 1]] - csum[indptr[hub_ids]]
            ).astype(np.float32)
            # keys bitcast into the left half of the bucket row, values right
            buckets = np.concatenate([hkey8.view(np.float32), hval8], axis=1)
            hub_tables = dict(
                edge_pack=_pack_super(edge_pack), hbuckets=_pack_super(buckets)
            )
    else:
        hub_frac = 0.0
        hub_tables = dict(
            edge_pack=np.empty((0, SUPER_W), dtype=np.float32),
            hbuckets=np.empty((0, SUPER_W), dtype=np.float32),
        )

    with trace.span("pecanpy.layout.pack"):
        channels_data = [("nbr", nbr_p), ("wgt", wgt_p)]
        if with_thresholds:
            thr_p = np.ones((num_nodes, dpad), dtype=np.float32)
            small = ~is_hub_node
            thr_p[small] = thresholds[np.minimum(nbr_p[small], num_nodes)]
            channels_data.append(("thr", thr_p))
        if with_cdf:
            cdf = np.cumsum(wgt_p, axis=1, dtype=np.float64)
            total = np.maximum(cdf[:, -1:], 1e-30)
            cdf_p = np.minimum(cdf / total, 1.0).astype(np.float32)
            cdf_p[is_hub_node] = 1.0  # hub rows draw from the alias tables
            channels_data.append(("cdf", cdf_p))
        fused = pack_fused_host(channels_data)

    def put(arr):
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if not host.numel():  # an empty copy waits for nothing
            return host.to(device)
        with trace.sync("pecanpy.layout.table_upload"):
            return host.to(device)

    with trace.span("pecanpy.layout.upload"):
        tables = dict(
            fused=put(fused),
            deg=put(deg),
            threshold=put(thresholds),
            indptr=put(indptr.astype(np.int32)),
            edge_pack=put(hub_tables["edge_pack"]),
            hbuckets=put(hub_tables["hbuckets"]),
        )
    return DeviceCSR(
        **tables,
        channels=tuple(name for name, _ in channels_data),
        dpad=dpad,
        max_degree=true_max,
        gamma=gamma,
        has_hubs=has_hubs,
        symmetric=bool(symmetric),
        hub_frac=hub_frac,
    )


def device_csr_from_dense(
    dense: np.ndarray,
    gamma: float = 0.0,
    max_degree: Optional[int] = None,
    with_thresholds: bool = False,
    with_cdf: bool = False,
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
        with_cdf=with_cdf,
        degree_cap=degree_cap,
        symmetric=symmetric,
        device=device,
    )


# the tensor fields of a ``DeviceCSR``
TABLE_FIELDS = ("fused", "deg", "threshold", "indptr", "edge_pack", "hbuckets")


def move(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``; a copy between the host and a device is a sync
    (``utils/trace.py``)."""
    if not t.numel() or t.device.type == torch.device(device).type:
        return t.to(device)
    with trace.sync("pecanpy.layout.table_copy"):
        return t.to(device)


def to_device(dg: DeviceCSR, device) -> DeviceCSR:
    """``dg`` with every table on ``device``."""
    return dataclasses.replace(
        dg, **{f: move(getattr(dg, f), device) for f in TABLE_FIELDS}
    )


def host_graph(dg: DeviceCSR) -> DeviceCSR:
    """``dg`` with every table on the CPU (``pecanpy_tpu/models/base.py``
    ``get_host_graph``): what a rank lays out on its own device."""
    return to_device(dg, "cpu")


def graph_table_bytes(dg: DeviceCSR) -> int:
    """Bytes of the graph's tables (fused, hub and auxiliary)."""
    return sum(
        getattr(dg, f).numel() * getattr(dg, f).element_size() for f in TABLE_FIELDS
    )


# hash-bucket pad keys read as -1 (never a node id): a clamped probe past
# the table's end cannot fake a membership hit
NEG1 = float(np.int32(-1).view(np.float32))


def shard_rows(
    table: torch.Tensor, n_shards: int, shard: int, pad_value: float = 0.0
) -> Tuple[torch.Tensor, int]:
    """Rank ``shard``'s contiguous row slice of ``table`` padded to a
    multiple of ``n_shards`` rows (``distgraph.py:_shard_rows``): returns
    (the slice, rows per shard). Pad rows of the fused table read as
    zero-degree rows; no walker reaches them (node ids stay below N)."""
    r = table.shape[0]
    rows = max(-(-r // n_shards), 1)
    lo, hi = shard * rows, (shard + 1) * rows
    part = table[lo:min(hi, r)]
    pad = rows - part.shape[0]
    if pad:
        fill = table.new_full((pad,) + tuple(table.shape[1:]), pad_value)
        part = torch.cat([part, fill])
    return part, rows


def from_numpy(host, device="cpu") -> DeviceCSR:
    """The port's ``DeviceCSR`` from a JAX-package one with numpy leaves.

    ``host`` is any object with the JAX ``DeviceCSR`` attributes, e.g.
    ``jax.tree.map(np.asarray, jax_csr)``; hub tables and every channel
    carry over bit for bit.
    """

    def put(arr):
        return torch.from_numpy(np.array(arr)).to(device)

    return DeviceCSR(
        fused=put(host.fused),
        deg=put(host.deg),
        threshold=put(host.threshold),
        indptr=put(host.indptr),
        edge_pack=put(host.edge_pack),
        hbuckets=put(host.hbuckets),
        channels=tuple(host.channels),
        dpad=int(host.dpad),
        max_degree=int(host.max_degree),
        gamma=float(host.gamma),
        has_hubs=bool(host.has_hubs),
        symmetric=bool(host.symmetric),
        hub_frac=float(host.hub_frac),
    )
