"""Edge-partitioned walking: the graph's tables row-sharded over the ranks.

Counterpart of ``pecanpy_tpu/parallel/distgraph.py``. Data rank s holds the
contiguous node range ``[s * rows, (s + 1) * rows)`` of the fused table
(and the same split of the hub tables, ``edge_pack`` and ``hbuckets``),
walkers stay split over the data ranks, and every row fetch of the walk
engines becomes a collective over the data group:

* ``psum`` ("fetch by all-reduce"): all_gather the batch's ids (4 B per
  lane), gather the rows this rank owns, zero the others, and sum the
  rows over the ranks as **int32**: the fused rows carry int32 node ids
  bitcast into float32 lanes, denormals as floats, which a float sum may
  flush to zero. The integer sum is exact and the float payloads come
  back bit for bit;
* ``alltoall`` (request/response): each rank sends at most ``capacity``
  requests to each owner, owners answer with their rows, and lanes that
  did not fit retry in another round; the pending count is summed over
  the ranks, so every rank runs the same rounds.

The walk engines run unchanged on a ``ShardedDeviceCSR``: only
``gather_rows`` and the hub-table fetches differ, so for the same draws
the walks are bit-identical to the replicated layout's. The engines'
host-read loops sum their pending counts over the data group
(``loop_sync``), and the hub trial blocks take the plain path on
collectively fetched rows (``rejection.use_trial_kernels``): the trial
kernels read rows by node id from a local table.

Scope: SparseOTF / DenseOTF / FirstOrderUnweighted, node2vec+ and hub
graphs included (``walk_batch`` also serves PreCompFirstOrder on a
replicated graph).
"""
import dataclasses
from typing import Optional

import numpy as np
import torch

from pecanpy_tpu_torch.models import engine, modes
from pecanpy_tpu_torch.ops import rejection
from pecanpy_tpu_torch.ops.layout import NEG1, DeviceCSR, move, shard_rows
from pecanpy_tpu_torch.parallel.mesh import DATA_AXIS, Group, Mesh
from pecanpy_tpu_torch.utils import trace


def _collective_fetch(
    table: torch.Tensor, idx: torch.Tensor, rows_per_shard: int, group: Group
) -> torch.Tensor:
    """Rows ``idx`` (any shape) of a table row-sharded over ``group``:
    all_gather the ids, gather the rows this rank owns, int32 sum.
    Returns ``idx.shape + (row width,)`` float32."""
    shape = tuple(idx.shape)
    flat = idx.reshape(-1).to(torch.int32)
    all_idx = group.all_gather(flat)
    local = all_idx - group.rank * rows_per_shard
    mine = (local >= 0) & (local < rows_per_shard)
    rows = table[torch.clamp(local, 0, max(rows_per_shard - 1, 0)).long()]
    rows = torch.where(mine[:, None], rows.view(torch.int32), 0)
    rows = group.all_reduce(rows)
    b = flat.shape[0]
    out = rows[group.rank * b : (group.rank + 1) * b].view(torch.float32)
    return out.reshape(shape + (table.shape[1],))


@dataclasses.dataclass(frozen=True)
class ShardedDeviceCSR(DeviceCSR):
    """One rank's view of a row-sharded graph.

    ``fused``, ``edge_pack`` and ``hbuckets`` hold this rank's rows only;
    ``threshold`` stays whole (node2vec+ reads it by node id); ``deg`` and
    ``indptr`` are empty (no walker of the sharded path reads them). Row
    accessors work on fetched rows and are inherited unchanged.
    """

    global_nodes: int = 0
    group: Optional[Group] = None
    exchange: str = "psum"
    capacity: int = 0
    ep_rows: int = 0
    hb_rows: int = 0

    @property
    def num_nodes(self) -> int:  # the sentinel is the GLOBAL node count
        return self.global_nodes

    @property
    def rows_per_shard(self) -> int:
        return self.fused.shape[0]

    @property
    def loop_sync(self):
        return self.group.all_reduce

    def _fetch_ep_super(self, row: torch.Tensor) -> torch.Tensor:
        row = torch.clamp(row, 0, max(self.ep_rows * self.group.size - 1, 0))
        return _collective_fetch(self.edge_pack, row, self.ep_rows, self.group)

    def _fetch_hb_super(self, row: torch.Tensor) -> torch.Tensor:
        row = torch.clamp(row, 0, max(self.hb_rows * self.group.size - 1, 0))
        return _collective_fetch(self.hbuckets, row, self.hb_rows, self.group)

    def gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        if self.exchange == "alltoall":
            return self._gather_rows_a2a(idx)
        return _collective_fetch(self.fused, idx, self.rows_per_shard, self.group)

    def _gather_rows_a2a(self, idx: torch.Tensor) -> torch.Tensor:
        """Request/response fetch over all_to_all, in rounds of at most
        ``capacity`` requests per owner; the retry decision is the pending
        count summed over the ranks (a rank that left the loop early would
        deadlock the others' all_to_all)."""
        g, cap, rps = self.group, self.capacity, self.rows_per_shard
        s, w, dev = g.size, self.fused.shape[1], idx.device
        idx = idx.to(torch.int32)
        b = idx.shape[0]
        owners = torch.arange(s, device=dev)
        rows_out = torch.zeros((b, w), dtype=torch.int32, device=dev)
        served = torch.zeros(b, dtype=torch.bool, device=dev)
        pending, t = 1, 0
        while pending > 0 and t < b + 1:
            owner = torch.where(served, s, torch.div(idx, rps, rounding_mode="floor"))
            onehot = owner[:, None] == owners[None, :]
            rank = torch.cumsum(onehot.to(torch.int32), dim=0) - 1
            rank = torch.where(onehot, rank, 0).sum(dim=1)
            fits = ~served & (rank < cap)
            slot = torch.where(fits, owner * cap + rank, s * cap).long()
            send = torch.full((s * cap + 1,), -1, dtype=torch.int32, device=dev)
            send[slot] = idx  # slot s * cap takes the lanes that do not fit
            recv = g.all_to_all(send[: s * cap])
            local = recv - g.rank * rps
            valid = (local >= 0) & (local < rps)
            got = self.fused[torch.clamp(local, 0, rps - 1).long()].view(torch.int32)
            back = g.all_to_all(torch.where(valid[:, None], got, 0))
            mine = back[torch.clamp(slot, max=s * cap - 1)]
            rows_out = torch.where(fits[:, None], mine, rows_out)
            served = served | fits
            left = g.all_reduce((~served).sum(dtype=torch.int32))
            with trace.sync("pecanpy.parallel.pending_read"):
                pending = int(left)
            t += 1
        return rows_out.view(torch.float32)


def exchange_cost_model(b_local: int, n_shards: int, width: int) -> dict:
    """Per-rank bytes moved by ONE row fetch under each exchange.

    Copied from ``pecanpy_tpu/parallel/distgraph.py:exchange_cost_model``
    (pure arithmetic). psum: the id all_gather receives (S - 1) * b_local
    ids, and the all-reduce of the [S * b_local, W] masked rows counts
    twice its buffer. alltoall: requests and replies of ``cap`` lanes per
    owner, out and in, with cap ~ b_local / S + 4 sqrt(b_local / S) + 8.
    ``pick`` takes alltoall only at a 2x modeled advantage.
    """
    per_shard = max(b_local // n_shards, 1)
    cap = per_shard + 4 * int(np.sqrt(per_shard)) + 8
    psum_bytes = 4 * (
        (n_shards - 1) * b_local  # id all_gather
        + 2 * n_shards * b_local * width  # row all-reduce (ring)
    )
    a2a_bytes = 4 * (
        2 * n_shards * cap  # request ids out + in
        + 2 * n_shards * cap * width  # replies out + in
    )
    pick = "alltoall" if a2a_bytes * 2 < psum_bytes else "psum"
    return {
        "psum_bytes": int(psum_bytes),
        "a2a_bytes": int(a2a_bytes),
        "capacity": int(cap),
        "pick": pick,
    }


def resolve_exchange(exchange: str, b_local: int, n_shards: int, width: int) -> str:
    """Resolve "auto" to a concrete exchange via the cost model."""
    if exchange != "auto":
        return exchange
    return exchange_cost_model(b_local, n_shards, width)["pick"]


def shard_graph(graph: DeviceCSR, mesh: Mesh) -> ShardedDeviceCSR:
    """This rank's ``ShardedDeviceCSR``: its data rank's rows of a host
    graph, on its device (only that slice is copied). The rows per rank
    of each table (JAX: ``ShardMeta``) are the graph's ``rows_per_shard``,
    ``ep_rows`` and ``hb_rows``."""
    n_shards, shard, dev = mesh.shape[DATA_AXIS], mesh.data_rank, mesh.device
    fused, _ = shard_rows(graph.fused, n_shards, shard)
    ep, ep_rows = shard_rows(graph.edge_pack, n_shards, shard)
    hb, hb_rows = shard_rows(graph.hbuckets, n_shards, shard, pad_value=NEG1)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return ShardedDeviceCSR(
        fused=move(fused, dev),
        deg=empty,
        threshold=move(graph.threshold, dev),
        indptr=empty,
        edge_pack=move(ep, dev),
        hbuckets=move(hb, dev),
        channels=graph.channels,
        dpad=graph.dpad,
        max_degree=graph.max_degree,
        gamma=graph.gamma,
        has_hubs=graph.has_hubs,
        symmetric=graph.symmetric,
        hub_frac=graph.hub_frac,
        global_nodes=graph.num_nodes,
        group=mesh.data,
        ep_rows=ep_rows,
        hb_rows=hb_rows,
    )


def for_batch(
    dg: DeviceCSR, b_local: int, exchange: str = "auto", capacity: Optional[int] = None
) -> DeviceCSR:
    """``dg`` with its exchange resolved for batches of ``b_local`` lanes
    per rank (a replicated graph is returned as it is)."""
    if not isinstance(dg, ShardedDeviceCSR):
        return dg
    n_shards = dg.group.size
    if capacity is None:
        mean = max(b_local // n_shards, 1)
        capacity = mean + 4 * int(np.sqrt(mean)) + 8
    exch = resolve_exchange(exchange, b_local, n_shards, dg.fused.shape[1])
    return dataclasses.replace(dg, exchange=exch, capacity=capacity)


def fetch_rows(
    graph: DeviceCSR, mesh: Mesh, idx, exchange: str = "psum",
    capacity: Optional[int] = None,
) -> torch.Tensor:
    """The exchange alone: rows ``idx[data rank]`` of a host graph's fused
    table, fetched through this rank's row-sharded copy (``idx`` is
    [data ranks, b], the same on every rank). Returns [b, width] float32
    on the rank's device."""
    dg = shard_graph(graph, mesh)
    mine = torch.as_tensor(np.asarray(idx)[mesh.data_rank], device=mesh.device)
    return for_batch(dg, mine.shape[0], exchange, capacity).gather_rows(mine)


def default_walk_draws(dg, mode, seed, entropy, b, walk_length, device):
    """The port's draws of one batch of walks of ``mode`` (a mode class): a
    ``TrialDrawStream`` for the hub walker, else ``[L, b, width]``
    uniforms, both from ``SeedSequence([seed, *entropy])``."""
    spec = mode.walk_spec()
    if spec.uses_hub_engine(dg):
        return engine.TrialDrawStream(seed, entropy, engine.HUB_TRIALS, device)
    return engine.walk_uniforms(seed, entropy, walk_length, b, device, spec.draw_width(dg))


def replay_draws(rounds: dict, device) -> engine.DrawFn:
    """A hub-walker draw provider that replays recorded rounds
    ``{round: (kk [T, B], u [T, 4, B])}`` (a test seam: spawned ranks get
    another generator's draws this way)."""
    table = {
        t: rejection.RoundDraws(
            torch.as_tensor(kk, device=device), torch.as_tensor(u, device=device)
        )
        for t, (kk, u) in rounds.items()
    }
    return lambda t, deg: table[t]


def walk_batch(dg, mode, p, q, extend, starts, walk_length, draws):
    """Walk one rank's batch of ``mode`` (a mode class, ``Base.WALK_SPEC``):
    the amortized hub walker (``draws`` a ``DrawFn``) or the scan engine
    (``draws`` the [L, b, width] uniforms), on a local or a row-sharded
    graph alike."""
    spec = mode.walk_spec()
    if spec.uses_hub_engine(dg):
        return engine.generate_walks_amortized(
            dg, starts, draws, walk_length, p, q, extend
        )
    first_fn, step_fn = spec.step_fns(p, q, extend)
    return engine.generate_walks(
        dg,
        lambda u, cur, rows: first_fn(dg, u, cur, rows),
        lambda u, cur, prev, cr, pr: step_fn(dg, u, cur, prev, cr, pr),
        starts,
        draws,
        walk_length,
    )


# walk draws of the multi-rank path: SeedSequence([seed, WALK_STREAM,
# batch, data rank]) (``parallel/train.py:RNG_SCHEME``)
WALK_STREAM = 2


def simulate_walks_distributed(
    graph: DeviceCSR,
    mesh: Mesh,
    starts: np.ndarray,
    walk_length: int,
    p: float = 1.0,
    q: float = 1.0,
    extend: bool = False,
    mode: type = modes.SparseOTF,
    seed: Optional[int] = 0,
    exchange: str = "auto",
    capacity: Optional[int] = None,
    *,
    _draws=None,
):
    """Walks over an edge-partitioned graph, called by every rank.

    Every rank passes the same host ``graph`` (CPU tensors) and the same
    full ``starts`` schedule, and gets back its data rank's rows of the
    result, ``(walks [b, L + 1], eff [b])`` on its device: rank s serves
    ``starts[s * b_local : (s + 1) * b_local]`` of the schedule padded with
    node 0 to a multiple of the data ranks (the pads are dropped).

    ``mode``: the walk mode's class (its ``WALK_SPEC`` must allow edge).
    ``exchange``: "psum", "alltoall" or "auto" (``exchange_cost_model``).
    ``_draws``: a test seam, one entry per data rank: the scan engine's
    [L, b_local(, width)] uniforms, or the hub walker's recorded rounds
    (``replay_draws``).
    """
    if not mode.walk_spec().edge:
        raise ValueError(
            f"partition='edge' does not support mode {mode.__name__!r}; use SparseOTF"
        )
    dg = shard_graph(graph, mesh)
    n_shards, shard, dev = mesh.shape[DATA_AXIS], mesh.data_rank, mesh.device
    total = int(np.asarray(starts).size)
    padded = np.pad(np.asarray(starts, dtype=np.int32), (0, (-total) % n_shards))
    b = padded.size // n_shards
    with trace.sync("pecanpy.walk.start_upload"):
        mine = torch.from_numpy(padded[shard * b : (shard + 1) * b]).to(dev)
    dg = for_batch(dg, b, exchange, capacity)
    if _draws is None:
        draws = default_walk_draws(dg, mode, seed or 0, (WALK_STREAM, 0, shard), b, walk_length, dev)
    elif mode.walk_spec().uses_hub_engine(dg):
        draws = replay_draws(_draws[shard], dev)
    else:
        draws = torch.as_tensor(np.asarray(_draws[shard]), device=dev)
    walks, eff = walk_batch(dg, mode, p, q, extend, mine, walk_length, draws)
    keep = max(min(total - shard * b, b), 0)
    return walks[:keep], eff[:keep]
