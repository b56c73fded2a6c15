"""Host-side builders for the hub (high-degree) node structures.

Copied from ``pecanpy_tpu/ops/hubs.py`` (constants, ``hub_hash``,
``_vose_alias``, ``build_edge_pack``, ``build_bucket_hash`` and the int32
address guards of ``build_hub_structures``), with the Python builders
only: the JAX package's native C++ builder is not ported yet (ROADMAP.md,
item 11).

Nodes whose degree exceeds ``degree_cap`` leave the fused table and are
served by two O(E_hub) flat structures:

* **Packed edge rows** (``edge_pack [E_hub, 8]``): one row per hub edge
  holding a fully resolved Vose alias slot: acceptance probability plus
  the neighbor and weight of both the slot itself and its alias target.
  A first-order draw ~ w(cur, .) picks a uniform slot, loads its row and
  takes self or alias against the acceptance.
* **Bucketized neighbor hash** (``hkey8/hval8 [NB, 8]``): every neighbor
  of a hub lives in exactly one 8-slot bucket chosen by a multiplicative
  hash; the bucket count doubles until nothing overflows. "Is x a
  neighbor of prev" is one bucket load and 8 compares.
"""
from typing import Tuple

import numpy as np

# Fused-row marker slots for hub nodes (nbr channel, int32):
#   slot 0: N + 1 + degree           (> N marks the row as a hub)
#   slot 1: base row of the node's slice of edge_pack
#   slot 2: base row of the node's hash buckets
#   slot 3: log2(number of hash buckets)
# and wgt channel slot 0 carries the node's noise threshold, slot 1 the
# node's total edge weight.
HUB_MARKER_SLOTS = 4

# Knuth multiplicative hash constant (as uint32 arithmetic)
KNUTH = 2654435761

# 8-slot bucket: one bucket load answers membership
BUCKET_WIDTH = 8

# edge_pack column layout (float32 row; int columns are bitcast)
EP_ACCEPT = 0  # alias acceptance probability q
EP_NBR_SELF = 1  # neighbor id of this slot (int32 bitcast)
EP_WGT_SELF = 2  # edge weight of this slot
EP_NBR_ALIAS = 3  # neighbor id of the alias target (int32 bitcast)
EP_WGT_ALIAS = 4  # edge weight of the alias target
EP_WIDTH = 8


def hub_hash(x, size_mask):
    """Bucket index of key x (uint32 wraparound arithmetic)."""
    h = (np.uint64(x) * np.uint64(KNUTH)) & np.uint64(0xFFFFFFFF)
    return h & np.uint64(size_mask)


def _vose_alias(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias table for one weight vector (reference pecanpy.py:617-665)."""
    k = w.size
    q = w.astype(np.float64) * (k / w.sum())
    j = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if q[i] < 1.0]
    large = [i for i in range(k) if q[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        j[s] = g
        q[g] = q[g] + q[s] - 1.0
        (small if q[g] < 1.0 else large).append(g)
    return j, q.astype(np.float32)


def build_edge_pack(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    hub_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resolved alias rows for every hub edge.

    Returns:
        edge_pack: [E_hub, EP_WIDTH] float32 (see EP_* column layout).
        hub_base: per-hub base row into edge_pack (aligned with hub_ids).
    """
    counts = (indptr[hub_ids + 1] - indptr[hub_ids]).astype(np.int64)
    hub_base = np.concatenate([[0], np.cumsum(counts)])[:-1].astype(np.int32)
    total = int(counts.sum())
    pack = np.zeros((total, EP_WIDTH), dtype=np.float32)
    packi = pack.view(np.int32)  # bitcast view for the int columns

    out = 0
    for u, k in zip(hub_ids, counts):
        lo = int(indptr[u])
        nbr = indices[lo : lo + k].astype(np.int32)
        wgt = data[lo : lo + k].astype(np.float32)
        j, q = _vose_alias(wgt)
        pack[out : out + k, EP_ACCEPT] = q
        packi[out : out + k, EP_NBR_SELF] = nbr
        pack[out : out + k, EP_WGT_SELF] = wgt
        packi[out : out + k, EP_NBR_ALIAS] = nbr[j]
        pack[out : out + k, EP_WGT_ALIAS] = wgt[j]
        out += k
    return pack, hub_base


def build_bucket_hash(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    hub_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucketized neighbor hash tables for the hub nodes.

    Returns:
        hkey8: [NB, 8] int32 neighbor ids (-1 = empty slot).
        hval8: [NB, 8] float32 edge weights, aligned with hkey8.
        bucket_base: per-hub base bucket row (aligned with hub_ids).
        bucket_log: per-hub log2(bucket count).

    Every key lives in exactly the bucket its hash selects; a node's
    bucket count doubles until no bucket exceeds 8 keys.
    """
    tables_k, tables_v = [], []
    bucket_base = np.zeros(hub_ids.size, dtype=np.int32)
    bucket_log = np.zeros(hub_ids.size, dtype=np.int32)
    offset = 0
    for i, u in enumerate(hub_ids):
        lo, hi = int(indptr[u]), int(indptr[u + 1])
        keys = indices[lo:hi].astype(np.int64)
        vals = data[lo:hi].astype(np.float32)
        # ~4 keys per 8-slot bucket on average
        log2 = max(2, int(np.ceil(np.log2(max(keys.size / 4.0, 1.0)))))
        while True:
            nb = 1 << log2
            b = hub_hash(keys, nb - 1).astype(np.int64)
            order = np.argsort(b, kind="stable")
            counts = np.bincount(b, minlength=nb)
            if counts.max() <= BUCKET_WIDTH:
                break
            log2 += 1  # a bucket overflowed: double and retry
        tk = np.full((nb, BUCKET_WIDTH), -1, dtype=np.int32)
        tv = np.zeros((nb, BUCKET_WIDTH), dtype=np.float32)
        slot_in_bucket = np.arange(keys.size) - np.concatenate(
            [[0], np.cumsum(counts)]
        )[b[order]]
        tk[b[order], slot_in_bucket] = keys[order].astype(np.int32)
        tv[b[order], slot_in_bucket] = vals[order]
        tables_k.append(tk)
        tables_v.append(tv)
        bucket_base[i] = offset
        bucket_log[i] = log2
        offset += nb

    if tables_k:
        hkey8 = np.concatenate(tables_k)
        hval8 = np.concatenate(tables_v)
    else:
        hkey8 = np.empty((0, BUCKET_WIDTH), dtype=np.int32)
        hval8 = np.empty((0, BUCKET_WIDTH), dtype=np.float32)
    return hkey8, hval8, bucket_base, bucket_log


def build_hub_structures(indptr, indices, data, hub_ids):
    """All hub structures in one call (the Python builders).

    Returns (edge_pack, hub_base, hkey8, hval8, bucket_base, bucket_log).

    Raises ValueError when the hub-edge or bucket address space exceeds
    int32 range: ``hub_base``/``bucket_base`` (and the marker slots packed
    into the fused rows) are int32 offsets, and the samplers compute
    ``base + slot`` in int32.
    """
    total_hub_edges = int(
        (np.asarray(indptr)[np.asarray(hub_ids) + 1]
         - np.asarray(indptr)[np.asarray(hub_ids)]).sum()
    )
    if total_hub_edges >= 2**31:
        raise ValueError(
            f"hub edge total {total_hub_edges} exceeds the int32 address "
            "space of the packed alias rows; raise degree_cap"
        )
    edge_pack, hub_base = build_edge_pack(indptr, indices, data, hub_ids)
    hkey8, hval8, bucket_base, bucket_log = build_bucket_hash(
        indptr, indices, data, hub_ids
    )
    if hkey8.shape[0] >= 2**31:
        raise ValueError(
            f"hub bucket total {hkey8.shape[0]} exceeds the int32 address "
            "space of the neighbor hash tables"
        )
    return edge_pack, hub_base, hkey8, hval8, bucket_base, bucket_log
