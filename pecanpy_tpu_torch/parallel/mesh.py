"""Ranks, process groups and collectives of the multi-rank path.

Counterpart of ``pecanpy_tpu/parallel/mesh.py``. The JAX package runs one
controller over a ``(data, model)`` device mesh; the port runs one process
per rank (SPMD), each with an explicit device and explicit process groups:

* rank ``r`` of a world of ``W = D * M`` ranks sits at
  ``(data = r // M, model = r % M)``, the grid of JAX's
  ``np.array(devices).reshape(n // mp, mp)``;
* the ranks of one data row form a **model group** (JAX: ``psum`` over
  ``model``): the embedding tables are split along ``dim`` over it;
* the ranks of one model column form a **data group** (``all_gather`` /
  ``psum`` / ``pmin`` over ``data``): the walk batch is split over it, and
  the graph is replicated or row-sharded over it.

What a rank holds (JAX: ``walk_shardings``, ``sgns_shardings``,
``shard_device_graph``): the whole graph under ``partition="replicated"``,
or its data rank's contiguous row slice of the fused and hub tables under
``partition="edge"`` (``ops/layout.py:shard_rows``); its column slice
``[:, m * dim / M : (m + 1) * dim / M]`` of both tables; its data rank's
slice of each walk batch.

Backend rule (``resolve_backend``, applied where the ranks start:
``launch.spawn`` and ``multihost.initialize``): ``nccl`` when every rank
has a card of its own, ``gloo`` on the CPU. Ranks that share a card take
``gloo`` only when it is asked for (``backend="gloo"``, or
``PECANPY_TPU_DIST_BACKEND``):
NCCL refuses two ranks on one device, and there is no silent fallback.
Gloo takes CUDA tensors for every collective the wrappers use (checked on
the card with torch 2.11.0+cu128: all_reduce, all_gather,
all_gather_into_tensor, all_to_all_single and broadcast) and copies them
through pinned host buffers itself, so the wrappers hand them over as they
are and only count those host copies; every kernel and op of the step
stays on the card.

Each collective is a span ``pecanpy.collective.<kind>`` and adds to the
open job's counters (``utils/trace.py``): ``collective.calls``,
``collective.bytes`` (the bytes it moves for this rank under the
accounting of ``distgraph.exchange_cost_model``: an all_gather receives
(S - 1) inputs, an all_reduce and an all_to_all count twice their buffer)
and ``collective.staged_bytes`` (the bytes gloo copies between the card
and the host for a collective on CUDA tensors, its input and its output).
A span, not a sync: NCCL returns at once, and gloo's own waits on the
card happen inside the call. (Staging them in the wrappers through pageable
memory instead cost 283-464 against 194-273 ms a fused step on an NVIDIA
H100 80GB HBM3 at 700 W: PERF.md section 6.)
"""
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pecanpy_tpu_torch.models.base import resolve_device
from pecanpy_tpu_torch.utils import trace

DATA_AXIS = "data"
MODEL_AXIS = "model"

def mesh_grid(n_devices: int, model_parallel: int = 1) -> np.ndarray:
    """[D, M] rank grid: row d holds the model group of data rank d."""
    if n_devices < 1 or model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n_devices} devices"
        )
    return np.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)


def resolve_backend(world: int, device, backend: Optional[str] = None) -> str:
    """The process-group backend of ``world`` ranks on ``device`` (see the
    module docstring). ``backend=None`` reads ``PECANPY_TPU_DIST_BACKEND``."""
    backend = backend or os.environ.get("PECANPY_TPU_DIST_BACKEND") or None
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or 'gloo'")
    if resolve_device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' needs CUDA devices; the CPU takes 'gloo'")
        return "gloo"
    cards = torch.cuda.device_count()
    if world > cards and backend != "gloo":
        raise ValueError(
            f"{world} ranks share {cards} CUDA device(s): NCCL refuses two "
            "ranks on one device. Pass backend='gloo' (or set "
            "PECANPY_TPU_DIST_BACKEND=gloo) to run them over gloo, which "
            "stages CUDA tensors through host memory"
        )
    return backend or "nccl"


def rank_device(rank: int, device) -> torch.device:
    """``cuda:(rank % device_count)`` for a CUDA run, else the CPU; a CUDA
    request without a card raises (``models.base.resolve_device``)."""
    if resolve_device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Group:
    """One process group and its collectives (JAX: one mesh axis).

    Every collective runs, even on a group of one rank (an identity then),
    so that a one-rank world still drives its backend.
    """

    def __init__(self, pg, ranks, my_rank: int, gloo: bool):
        self.pg = pg
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(my_rank)
        self.gloo = gloo

    def _count(self, t: torch.Tensor, moved: int, out_elems: int):
        trace.count("collective.calls")
        trace.count("collective.bytes", moved * t.element_size())
        if self.gloo and t.is_cuda:
            staged = (t.numel() + out_elems) * t.element_size()
            trace.count("collective.staged_bytes", staged)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``psum``) or min (``pmin``) of ``t`` over the group, reduced
        in place and returned: ``t`` is consumed (every caller passes a
        temporary it does not read again)."""
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
        with trace.span(f"pecanpy.collective.all_reduce_{op}"):
            self._count(t, 2 * t.numel(), t.numel())
            t = t.contiguous()
            dist.all_reduce(t, op=red, group=self.pg)
            return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Shards concatenated along dim 0, rank 0's first (JAX:
        ``all_gather(tiled=True)``)."""
        with trace.span("pecanpy.collective.all_gather"):
            self._count(t, (self.size - 1) * t.numel(), self.size * t.numel())
            t = t.contiguous()
            out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(out, t, group=self.pg)
            return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block k of dim 0 goes to rank k; block k of the result came from
        rank k (JAX: ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
        with trace.span("pecanpy.collective.all_to_all"):
            self._count(t, 2 * t.numel(), t.numel())
            t = t.contiguous()
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=self.pg)
            return out


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) grid, its device and groups."""

    rank: int
    world: int
    model_parallel: int
    device: torch.device
    backend: str
    data: Group
    model: Group

    @property
    def shape(self):
        return {DATA_AXIS: self.world // self.model_parallel, MODEL_AXIS: self.model_parallel}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    device="cuda",
) -> Mesh:
    """This rank's (data, model) mesh over the initialized process group
    (``launch.spawn`` or ``multihost.initialize`` starts the ranks, with
    the backend ``resolve_backend`` picks). Every rank of the world calls
    it: the groups are made collectively.

    Args:
        n_devices: the world size it expects (default: the world's).
        model_parallel: size of the model group; must divide the world.
        device: "cuda" (default; raises without a card) or "cpu"; a CUDA
            rank takes ``cuda:(rank % device_count)``.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh needs an initialized process group of {n_devices or 'N'} "
            "ranks: start them with parallel.launch.spawn or "
            "parallel.multihost.initialize"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks")
    grid = mesh_grid(world, model_parallel)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    used = dist.get_backend()
    groups = {}
    # every rank makes every group, in the same order
    for axis, members in (("model", grid), ("data", grid.T)):
        for ranks in members:
            pg = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = Group(pg, [int(r) for r in ranks], rank, used == "gloo")
    return Mesh(rank, world, model_parallel, dev, used, groups["data"], groups["model"])
