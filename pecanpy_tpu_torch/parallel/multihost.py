"""Multi-process execution, one process per rank.

Counterpart of ``pecanpy_tpu/parallel/multihost.py``. Every process calls
``initialize`` with the same coordinator and its own id, then runs the
identical program: ``global_mesh`` builds its (data, model) groups, the
collectives of ``parallel/distgraph.py`` and ``parallel/train.py`` cross
the processes, and each process holds only its own rows.

Typical worker::

    from pecanpy_tpu_torch.parallel import distgraph, multihost
    multihost.initialize("host0:1234", num_processes=4, process_id=rank)
    mesh = multihost.global_mesh()
    walks, eff = distgraph.simulate_walks_distributed(graph, mesh, starts, L)
    my_walks = multihost.local_array(walks)  # this process's rows

``torchrun`` sets the rendezvous variables itself: call ``initialize()``
without arguments there. ``embed(n_devices=N)`` called in every process
after ``initialize`` trains in place and returns the full embeddings on
every rank.
"""
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pecanpy_tpu_torch.parallel import mesh as mesh_lib


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """``torch.distributed.init_process_group`` for this process.

    Args:
        coordinator_address: "host:port" of rank 0's TCP store; None reads
            the ``env://`` variables (``torchrun``).
        num_processes / process_id: the world size and this rank.
        local_device_count: ranks per process; the port runs one (JAX:
            virtual CPU devices per process), so only None or 1.
        backend: per ``mesh.resolve_backend`` ("gloo" must be asked for
            when ranks share a card).
        device: "cuda" (default; raises without a card) or "cpu".
    """
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: the port runs one rank "
            "per process; start one process per device"
        )
    if coordinator_address is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        dist.init_process_group(mesh_lib.resolve_backend(world, device, backend))
        return
    dist.init_process_group(
        mesh_lib.resolve_backend(num_processes, device, backend),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def global_mesh(model_parallel: int = 1, device="cuda") -> mesh_lib.Mesh:
    """(data, model) mesh over every rank of every process; data rank d's
    rows of a split batch belong to process d (with model_parallel 1)."""
    return mesh_lib.make_mesh(None, model_parallel, device=device)


def local_array(arr) -> np.ndarray:
    """This process's rows of a split result: a rank holds only its own
    rows already, so this is the host copy of ``arr``."""
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr)


def process_slice(total: int) -> slice:
    """The contiguous [lo, hi) range of a length-``total`` leading axis
    owned by this process (equal split by process index)."""
    per = -(-total // dist.get_world_size())
    lo = dist.get_rank() * per
    return slice(lo, min(lo + per, total))
