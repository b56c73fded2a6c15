"""The batched walk engine: B walkers advance in lockstep, one step at a time.

Counterpart of ``pecanpy_tpu/models/engine.py:generate_walks``. The JAX
package compiles the step loop as a ``lax.scan``; here it is a Python
loop over the ``L - 1`` second-order steps, each a handful of tensor ops
on the whole batch.

The fused rows of the current AND previous node are carried from step to
step, so each step performs exactly ONE table gather: the row of the node
just stepped to. The previous node's row is last step's current row.

Every mode plugs in through two step callables:

    first_fn(u, cur, cur_rows)                  -> next   (1st-order)
    step_fn(u, cur, prev, cur_rows, prev_rows)  -> next   (2nd-order)

where ``u`` is the step's [B, 1] uniforms. Walk semantics (reference
``pecanpy.py:180-206``):

* column 0 holds the start node; steps fill columns 1..L;
* a walker whose current node has no neighbors stops: ``eff_len`` is L+1
  when it never stopped, j when the node reached at column j-1 had no
  out-edges;
* dead walkers keep emitting their resting node, which consumers never
  read because they cut each walk at its effective length.
"""
from typing import Callable, Tuple

import numpy as np
import torch

from pecanpy_tpu_torch.ops.layout import DeviceCSR

FirstFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
StepFn = Callable[..., torch.Tensor]


def walk_uniforms(
    seed: int, chunk_idx: int, walk_length: int, batch: int, device
) -> torch.Tensor:
    """[walk_length, batch] uniforms of one walk chunk.

    A pure function of (seed, chunk index), like the JAX package's
    ``fold_in(base_key, i)``, so the streaming trainer's passes see the
    identical chunk stream. Row s feeds step s + 1.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, chunk_idx]).generate_state(1)[0]))
    return torch.rand((walk_length, batch), generator=gen, device=device)


def generate_walks(
    graph: DeviceCSR,
    first_fn: FirstFn,
    step_fn: StepFn,
    start: torch.Tensor,
    u: torch.Tensor,
    walk_length: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance a batch of walkers ``walk_length`` steps.

    Args:
        graph: fused device CSR.
        first_fn / step_fn: mode-specific transition samplers.
        start: [B] int32 start nodes.
        u: [walk_length, B] uniforms in [0, 1); row 0 feeds the first
            step, row s the step that fills column s + 1.
        walk_length: number of steps L.

    Returns:
        walks: [B, L + 1] int32 node indices, column 0 = start.
        eff_len: [B] int32 effective walk lengths in [1, L + 1].
    """
    sentinel = graph.num_nodes
    start = start.to(torch.int32)
    start_rows = graph.gather_rows(start)
    alive = graph.rows_nbr(start_rows)[:, 0] != sentinel
    first = first_fn(u[0][:, None], start, start_rows)
    col1 = torch.where(alive, first, start)
    eff = torch.where(alive, walk_length + 1, 1).to(torch.int32)
    cols = [start, col1]
    if walk_length == 1:
        return torch.stack(cols, dim=1), eff

    cur, prev = col1, start
    cur_rows, prev_rows = graph.gather_rows(col1), start_rows
    for step_idx in range(2, walk_length + 1):
        has = graph.rows_nbr(cur_rows)[:, 0] != sentinel
        eff = torch.where(alive & ~has, step_idx, eff).to(torch.int32)
        alive = alive & has
        nxt = step_fn(u[step_idx - 1][:, None], cur, prev, cur_rows, prev_rows)
        nxt = torch.where(alive, nxt, cur)
        nxt_rows = graph.gather_rows(nxt)  # THE one gather per step
        prev, cur, prev_rows, cur_rows = cur, nxt, cur_rows, nxt_rows
        cols.append(nxt)
    return torch.stack(cols, dim=1), eff
