"""Spawn the ranks of a multi-rank run from a process that has none.

The JAX package drives all devices from one controller; the port runs one
process per rank. ``spawn`` keeps the single-controller call surface:
called in a process without an initialized process group, it starts
``nprocs`` ranks (``torch.multiprocessing``, start method ``spawn``), each
of which initializes the group through a file store under a temporary
directory (no TCP port: concurrent runs cannot collide), builds its
``parallel.mesh.Mesh`` and calls ``fn(mesh, *args, **kwargs)``. Each
rank's return value comes back to the caller through that directory.

Arguments travel by pickling: CPU tensors go through shared memory (the
host graph is not copied per rank), functions by reference (``fn`` must
be a module-level function of an importable module). A rank that raises
makes ``spawn`` raise, after the other ranks are stopped. CPU ranks run
one intra-op thread each.
"""
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from pecanpy_tpu_torch.parallel import mesh as mesh_lib


def _rank_main(rank, world, directory, backend, device, model_parallel, fn, args, kwargs):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(directory, 'store')}",
        world_size=world, rank=rank,
    )
    try:
        mesh = mesh_lib.make_mesh(world, model_parallel, device=device)
        out = fn(mesh, *args, **kwargs)
        torch.save(out, os.path.join(directory, f"rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(
    fn,
    nprocs: int,
    args=(),
    kwargs: Optional[dict] = None,
    model_parallel: int = 1,
    device="cuda",
    backend: Optional[str] = None,
) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``nprocs`` new ranks; returns
    their results, rank 0's first. Ranks take ``cuda:(rank %
    device_count)`` (``device="cuda"``, the default, raises without a
    card) or the CPU (``device="cpu"``). The backend follows
    ``mesh.resolve_backend`` (checked here, before any rank starts)."""
    mesh_lib.mesh_grid(nprocs, model_parallel)
    backend = mesh_lib.resolve_backend(nprocs, device, backend)
    with tempfile.TemporaryDirectory(prefix="pecanpy_ranks_") as directory:
        tmp_mp.start_processes(
            _rank_main,
            args=(nprocs, directory, backend, str(device), model_parallel, fn,
                  tuple(args), dict(kwargs or {})),
            nprocs=nprocs,
            start_method="spawn",
        )
        return [
            torch.load(os.path.join(directory, f"rank_{r}.pt"), weights_only=False)
            for r in range(nprocs)
        ]


def run_calls(mesh, calls):
    """Several calls on the same ranks (one ``spawn`` for all): each of
    ``calls`` is ``(fn, args, kwargs)`` and runs as
    ``fn(*args, mesh=mesh, **kwargs)``; returns their results in order."""
    return [fn(*args, mesh=mesh, **kwargs) for fn, args, kwargs in calls]
