"""First-order proposals from carried fused rows.

Counterpart of the non-hub branch of ``pecanpy_tpu/ops/rejection.py``
(``fused_propose`` and ``propose``). The hub branch (alias rows, bucket
probes, rejection trials) is not ported: graphs with hubs raise when
their layout is built (``ops/layout.py``).

In the JAX package ``propose`` splits its key into ``k_hub, k_small`` and
draws the non-hub uniform from ``k_small``; here that uniform is the
argument ``u``.
"""
from typing import Tuple

import torch

from pecanpy_tpu_torch.ops.layout import DeviceCSR


def fused_propose(
    dg: DeviceCSR, u: torch.Tensor, cur_rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw x ~ w(cur, .) by inverse CDF over the carried row.

    Args:
        u: [B, 1] uniforms in [0, 1).

    Returns:
        ([B] int32 x, [B] float32 w(cur, x)).
    """
    wgt = dg.rows_wgt(cur_rows)
    cdf = torch.cumsum(wgt, dim=-1)
    c = (cdf < u * cdf[:, -1:]).sum(dim=-1)
    c = torch.clamp(c, max=cdf.shape[-1] - 1)[:, None]
    x = dg.rows_nbr(cur_rows).gather(1, c)[:, 0]
    w = wgt.gather(1, c)[:, 0]
    return x, w


def propose(
    dg: DeviceCSR, u: torch.Tensor, cur_rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order draw x ~ w(cur, .) on a graph without hubs."""
    return fused_propose(dg, u, cur_rows)
