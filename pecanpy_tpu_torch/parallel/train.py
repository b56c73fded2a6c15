"""Multi-rank fused training: split walks and split SGNS updates.

Counterpart of ``pecanpy_tpu/parallel/train.py``, as SPMD processes: every
rank runs the same program on its own device (``parallel/mesh.py``). One
fused step per batch of starts:

* each data rank walks its slice of the batch over the graph, replicated
  on its device or row-sharded over the data group with collective row
  fetches (``partition="edge"``, ``parallel/distgraph.py``), hub graphs
  included;
* the walks train the SGNS tables, split along ``dim`` over the model
  group, with the collectives of ``sgns.make_step_body``: the pair scores
  summed over the model group, the update streams gathered over the data
  group, so every data rank applies the identical full stream to its
  table slice with the CUDA applier (kernel 2.1) and the tables stay
  identical across data ranks.

Draws (``RNG_SCHEME``): the tables' init as the single-device trainer's
(``sgns.init_tables(seed)``); the walks of batch i on data rank d from
``SeedSequence([seed, 2, i, d])``, so every epoch replays the same corpus,
the count pass sees exactly the walks training consumes, and the draws
depend on neither the partition nor the model rank; the SGNS draws of
global step g on data rank d from ``SeedSequence([seed, 1, g, d])``; the
stochastic-rounding seed is the data group's minimum of its ranks' seeds.
"""
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from pecanpy_tpu_torch.models import modes, sgns
from pecanpy_tpu_torch.models.sgns import SGNSConfig
from pecanpy_tpu_torch.ops import layout
from pecanpy_tpu_torch.ops.layout import DeviceCSR
from pecanpy_tpu_torch.parallel import distgraph
from pecanpy_tpu_torch.parallel.distgraph import WALK_STREAM
from pecanpy_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from pecanpy_tpu_torch.utils import trace
from pecanpy_tpu_torch.utils.checkpoint import SGNSCheckpointer, verify_rng_scheme

# Version tag of the multi-rank draw derivation (module docstring), stamped
# into every multi-rank checkpoint: a single-device snapshot
# (``sgns.RNG_SCHEME``) is refused here, and this one there.
RNG_SCHEME = "torch-multichip-seedsequence-v1"

# the replicated-graph budget of a CPU rank when
# ``PECANPY_TPU_REPLICATED_BUDGET_MB`` is unset: 8 GiB
CPU_REPLICATED_BUDGET_MB = 8192


def replicated_budget_bytes(device) -> int:
    """Graph-table bytes a rank replicates before ``partition="auto"``
    row-shards: ``PECANPY_TPU_REPLICATED_BUDGET_MB``, else half the card's
    memory (the rest holds the SGNS tables, walk buffers and the
    allocator's slack), else ``CPU_REPLICATED_BUDGET_MB`` on the CPU."""
    env = os.environ.get("PECANPY_TPU_REPLICATED_BUDGET_MB")
    if env is not None:
        return int(env) * (1 << 20)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return CPU_REPLICATED_BUDGET_MB * (1 << 20)


def resolve_partition(
    partition: str,
    graph_bytes: int,
    n_data_shards: int,
    edge_supported: bool = True,
    device="cpu",
) -> str:
    """Resolve ``partition="auto"``: replicate while the graph's tables fit
    the rank's budget (``replicated_budget_bytes``), row-shard ("edge")
    past it. A single data rank, or a mode without an edge-partitioned
    walker (the PreComp family), always replicates."""
    if partition != "auto":
        return partition
    if n_data_shards <= 1 or not edge_supported:
        return "replicated"
    return "edge" if graph_bytes > replicated_budget_bytes(device) else "replicated"


def _to(x, device):
    """``x`` (a tensor, array, ``StepDraws`` or recorded rounds) on ``device``."""
    if isinstance(x, sgns.StepDraws):
        return dataclasses.replace(
            x, **{f: _to(getattr(x, f), device) for f in ("u_sub", "eff_win", "neg_slots")}
        )
    if isinstance(x, dict):
        return distgraph.replay_draws(x, device)
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device)


@dataclasses.dataclass
class MultichipTrainer:
    """One rank's share of the fused multi-rank step.

    ``graph`` is a host graph (CPU tensors, ``layout.host_graph``). Under
    ``partition="replicated"`` the rank copies it whole to its device;
    under ``"edge"`` only its data rank's row slice
    (``distgraph.shard_graph``), and the walks' row fetches become the
    collective exchange (``exchange``: psum, alltoall, or auto by the cost
    model). The walks, and so the trained tables, are bit-identical across
    the two layouts for the same seed. ``mode`` is the walk mode's class:
    its ``WALK_SPEC`` picks the walker, the draws and whether the graph
    may be row-sharded.
    """

    mesh: Mesh
    graph: DeviceCSR
    config: SGNSConfig
    walk_length: int
    p: float = 1.0
    q: float = 1.0
    extend: bool = False
    mode: type = modes.SparseOTF
    partition: str = "replicated"
    exchange: str = "auto"

    def __post_init__(self):
        spec = self.mode.walk_spec()  # raises for a mode without one
        dev = self.mesh.device
        if self.partition == "edge":
            if not spec.edge:
                raise ValueError(
                    f"partition='edge' does not support mode {self.mode.__name__!r} "
                    "(PreComp's per-edge tables are single-device by "
                    "design); use SparseOTF"
                )
            self.dg = distgraph.shard_graph(self.graph, self.mesh)
        elif self.partition == "replicated":
            self.dg = layout.to_device(self.graph, dev)
        else:
            raise ValueError(
                f"unknown partition {self.partition!r}; use 'replicated' or 'edge'"
            )
        m = self.mesh.shape[MODEL_AXIS]
        if self.config.dim % m:
            raise ValueError(f"model_parallel={m} does not divide dim={self.config.dim}")
        width = self.config.dim // m
        self.cols = slice(self.mesh.model_rank * width, (self.mesh.model_rank + 1) * width)
        self.num_nodes = self.graph.num_nodes
        self.dtype = sgns.resolve_table_dtype(self.config, self.num_nodes, dev)
        self._body = sgns.make_step_body(
            self.num_nodes, self.config, model_group=self.mesh.model,
            data_group=self.mesh.data,
        )

    # -- state ----------------------------------------------------------------

    def init_params(self, seed: int):
        """This rank's column slices of the single-device init."""
        w_in, w_out = sgns.init_tables(
            seed, self.num_nodes, self.config.dim, self.dtype, self.mesh.device
        )
        return w_in[:, self.cols].contiguous(), w_out[:, self.cols].contiguous()

    def tables_from_numpy(self, w_in, w_out):
        """This rank's column slices of host tables [N, dim] (e.g. the JAX
        package's, logical rows), on its device and in its dtype."""
        return sgns.tables_from_numpy(
            np.asarray(w_in)[:, self.cols], np.asarray(w_out)[:, self.cols],
            self.mesh.device, self.dtype,
        )

    def gather_table(self, w: torch.Tensor) -> torch.Tensor:
        """[N, dim] table from the model group's column slices (a
        collective: every rank calls it)."""
        return self.mesh.model.all_gather(w.T.contiguous()).T

    def shard_batch(self, starts) -> torch.Tensor:
        """This data rank's slice of a batch of starts, padded with node 0
        to a multiple of the data ranks (the pad walks train, as in the
        JAX package)."""
        n_shards = self.mesh.shape[DATA_AXIS]
        starts = np.asarray(starts, dtype=np.int32)
        starts = np.pad(starts, (0, (-starts.size) % n_shards))
        b = starts.size // n_shards
        d = self.mesh.data_rank
        with trace.sync("pecanpy.walk.start_upload"):
            return torch.from_numpy(starts[d * b : (d + 1) * b]).to(self.mesh.device)

    # -- stepping -------------------------------------------------------------

    def walk_draws(self, seed: int, batch_idx: int, b: int):
        """The draws of batch ``batch_idx`` of ``b`` walks on this data rank."""
        return distgraph.default_walk_draws(
            self.dg, self.mode, seed, (WALK_STREAM, batch_idx, self.mesh.data_rank),
            b, self.walk_length, self.mesh.device,
        )

    def step_draws(self, seed: int, step_idx: int, wb: int, table_size: int):
        return sgns.draw_step(
            seed, step_idx, wb, self.walk_length + 1, self.config, table_size,
            self.mesh.device, data_rank=self.mesh.data_rank,
        )

    def walk(self, starts: torch.Tensor, draws):
        """(walks, eff) of this data rank's starts under ``draws``."""
        dg = distgraph.for_batch(self.dg, starts.shape[0], self.exchange)
        return distgraph.walk_batch(
            dg, self.mode, self.p, self.q, self.extend, starts, self.walk_length, draws
        )

    def count_tokens(self, starts, seed: int, batch_idx: int = 0, draws=None):
        """[N] token counts of the walks batch ``batch_idx`` of ``starts``
        generates, summed over the data ranks."""
        local = self.shard_batch(starts)
        draws = self.walk_draws(seed, batch_idx, local.shape[0]) if draws is None else draws
        walks, eff = self.walk(local, draws)
        counts = sgns._count_tokens(walks, eff, self.num_nodes)
        return self.mesh.data.all_reduce(counts)

    def step(self, w_in, w_out, starts, keep_prob, neg_table, lr, walk_draws, step_draws):
        """One fused walk + SGNS step on this rank's starts (updates its
        table slices in place and returns them)."""
        walks, eff = self.walk(starts, walk_draws)
        return self._body(w_in, w_out, walks, eff, keep_prob, neg_table, lr, step_draws)


def run_fused_step(
    mesh: Mesh,
    graph: DeviceCSR,
    config: SGNSConfig,
    walk_length: int,
    tables,
    starts,
    keep_prob,
    neg_table,
    lr: float,
    *,
    seed: int = 0,
    step_idx: int = 0,
    walk_draws=None,
    step_draws=None,
    **trainer_kw,
):
    """One fused step from host tables ``(w_in, w_out)`` [N, dim], on every
    rank, after the count pass over the same batch; returns
    ``{"w_in", "w_out", "counts"}``: the gathered tables and the [N] token
    counts (summed over the data ranks), float32 numpy arrays.

    ``walk_draws`` / ``step_draws``: one entry per data rank (uniforms or
    recorded rounds, and ``StepDraws``) replacing the port's own draws
    (the tests hand in the JAX key tree's numbers).
    """
    trainer = MultichipTrainer(mesh, graph, config, walk_length, **trainer_kw)
    dev, d = mesh.device, mesh.data_rank
    w_in, w_out = trainer.tables_from_numpy(*tables)
    local = trainer.shard_batch(starts)
    neg_table = _to(neg_table, dev)

    def walk():  # a fresh provider per pass: the count sees the step's walks
        if walk_draws is None:
            return trainer.walk_draws(seed, 0, local.shape[0])
        return _to(walk_draws[d], dev)

    counts = trainer.count_tokens(starts, seed, draws=walk())
    draws = (
        trainer.step_draws(seed, step_idx, local.shape[0], neg_table.shape[0])
        if step_draws is None else _to(step_draws[d], dev)
    )
    trainer.step(w_in, w_out, local, _to(keep_prob, dev), neg_table, lr, walk(), draws)
    out = {k: trainer.gather_table(w) for k, w in (("w_in", w_in), ("w_out", w_out))}
    out["counts"] = counts
    with trace.sync("pecanpy.parallel.table_read"):
        return {k: v.float().cpu().numpy() for k, v in out.items()}


@trace.job("pecanpy.parallel.train_streaming")
def train_streaming_multichip(
    trainer: MultichipTrainer,
    starts: np.ndarray,
    epochs: int = 1,
    seed: int = 0,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    batch: Optional[int] = None,
    max_steps: Optional[int] = None,
) -> np.ndarray:
    """Two-pass streaming trainer on the ranks: a count pass, then fused
    walk + train steps (walks regenerated, never stored). Every rank calls
    it and gets the same [N, dim] float32 embeddings.

    Args:
        trainer: this rank's ``MultichipTrainer``.
        starts: the full start schedule (every node x num_walks, shuffled:
            ``Base._start_nodes``), the same on every rank.
        batch: walks per step over all data ranks; default
            ``sgns.resolve_batch_walks`` (the single-device update
            granularity) rounded up to a multiple of the data ranks and
            capped by the schedule. A mesh-sized floor would collapse a
            small corpus into a few giant mean-aggregated updates
            (``pecanpy_tpu``'s block-model micro-F1 fell to 0.25).
        checkpoint_dir / checkpoint_every: rank 0 snapshots the tables
            (gathered over the model group, logical rows) every
            ``checkpoint_every`` steps; with a snapshot present every rank
            resumes from it, bit-identical to an uninterrupted run.
        max_steps: stop after this many steps (the lr schedule stays
            pinned to the full plan); the count pass still walks every
            batch.

    The call is the job ``pecanpy.parallel.train_streaming`` (a span of
    ``pecanpy.embed`` inside an ``embed`` call), with the span
    ``pecanpy.parallel.count_pass`` and the counters ``parallel.train_ns``
    (the steps' host time), ``parallel.steps`` (steps run, past a resume),
    ``parallel.batches`` and ``parallel.batch`` (walks a step, all data
    ranks).
    """
    mesh, config = trainer.mesh, trainer.config
    n, dev = trainer.num_nodes, mesh.device
    n_shards = mesh.shape[DATA_AXIS]
    starts = np.asarray(starts, dtype=np.int32)
    if batch is None:
        batch = min(
            max(sgns.resolve_batch_walks(config, n, trainer.walk_length + 1), n_shards),
            max(starts.size, n_shards),
        )
    batch += (-batch) % n_shards
    batches = [starts[lo : lo + batch] for lo in range(0, starts.size, batch)]
    lead = verbose and mesh.rank == 0

    # pass 1: the token counts of the identical walk stream training
    # replays (walk draws are per batch), and each batch's token sum for
    # the lr schedule; summed over the data ranks once, at the end
    t0 = time.perf_counter()
    with trace.span("pecanpy.parallel.count_pass"):
        counts = torch.zeros(n, dtype=torch.float32, device=dev)
        tokens = torch.zeros(len(batches), dtype=torch.float32, device=dev)
        for i, part in enumerate(batches):
            local = trainer.shard_batch(part)
            walks, eff = trainer.walk(local, trainer.walk_draws(seed, i, local.shape[0]))
            counts += sgns._count_tokens(walks, eff, n)
            tokens[i] = eff.sum()
        both = mesh.data.all_reduce(torch.cat([counts, tokens]))
        counts = both[:n]
        with trace.sync("pecanpy.sgns.tokens_read"):
            batch_tokens = both[n:].cpu().numpy().astype(np.float64)
        with trace.sync("pecanpy.sgns.counts_read"):
            counts_np = counts.cpu().numpy()
    count_s = time.perf_counter() - t0
    keep_prob = sgns._keep_probs(counts, config.sample)
    neg_host = sgns.build_negative_table(counts_np, seed=seed)
    with trace.sync("pecanpy.sgns.neg_upload"):
        neg_table = torch.from_numpy(neg_host).to(dev)
    total_tokens = float(counts_np.sum()) * epochs
    if lead:
        print(f"multichip count pass: {len(batches)} batches of {batch} walks, "
              f"{count_s:.1f} s", flush=True)

    w_in, w_out = trainer.init_params(seed)
    ckpt, resume = None, 0
    if checkpoint_dir is not None:
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be at least 1, got {checkpoint_every}")
        ckpt = SGNSCheckpointer(checkpoint_dir)
        if ckpt.latest_step() is not None:
            r_in, r_out, meta = ckpt.restore()
            verify_rng_scheme(meta, RNG_SCHEME)
            for table, saved in ((w_in, r_in), (w_out, r_out)):
                if tuple(saved.shape) != (n, config.dim):
                    raise ValueError(
                        f"checkpoint table {tuple(saved.shape)} does not match "
                        f"this run's {(n, config.dim)}"
                    )
                with trace.sync("pecanpy.sgns.table_upload"):
                    table.copy_(saved[:, trainer.cols].to(device=dev, dtype=table.dtype))
            resume = int(meta["next_step"])

    def finish():
        trace.count("parallel.train_ns", int((time.perf_counter() - t1) * 1e9))
        trace.count("parallel.steps", step_idx - resume)
        trace.count("parallel.batches", len(batches))
        trace.count("parallel.batch", batch)
        full = trainer.gather_table(w_in).float()
        with trace.sync("pecanpy.sgns.table_read"):
            return full.cpu().numpy()

    step_idx, done_tokens = 0, 0.0
    t1 = time.perf_counter()
    for _epoch in range(epochs):
        for i, part in enumerate(batches):
            if max_steps is not None and step_idx >= max_steps:
                return finish()
            if step_idx < resume:
                done_tokens += batch_tokens[i]
                step_idx += 1
                continue
            lr = max(
                config.min_alpha,
                config.alpha
                - (config.alpha - config.min_alpha) * (done_tokens / max(total_tokens, 1.0)),
            )
            local = trainer.shard_batch(part)
            trainer.step(
                w_in, w_out, local, keep_prob, neg_table, lr,
                trainer.walk_draws(seed, i, local.shape[0]),
                trainer.step_draws(seed, step_idx, local.shape[0], neg_table.shape[0]),
            )
            done_tokens += batch_tokens[i]
            step_idx += 1
            sgns._progress(lead, t1, done_tokens, total_tokens)
            if ckpt is not None and step_idx % checkpoint_every == 0:
                full_in, full_out = trainer.gather_table(w_in), trainer.gather_table(w_out)
                if mesh.rank == 0:
                    ckpt.save(step_idx, full_in, full_out,
                              {"next_step": step_idx, "rng_scheme": RNG_SCHEME})
    return finish()


def embed_rank(mesh: Mesh, trainer_args: tuple, starts: np.ndarray, **train_kw):
    """One spawned rank of ``embed(n_devices > 1)``: ``MultichipTrainer(mesh,
    *trainer_args)`` and the streaming pipeline; the embeddings on rank 0,
    None on the others."""
    trainer = MultichipTrainer(mesh, *trainer_args)
    emb = train_streaming_multichip(trainer, starts, **train_kw)
    return emb if mesh.rank == 0 else None
