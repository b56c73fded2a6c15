"""Batched inverse-CDF sampling over padded weight rows.

Counterpart of the categorical part of ``pecanpy_tpu/ops/sampling.py``.
The uniforms come in as an argument (``u`` of shape [B, 1] in [0, 1)),
so tests can feed the JAX key tree's numbers and compare choices exactly.
"""
import torch


def pick_int_columns(values: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """values[b, choice[b]] for int32 rows (exact: no float round trip)."""
    return values.gather(1, choice.long()[:, None])[:, 0]


def sample_from_cdf(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Sample one column per row from inclusive CDF rows.

    Args:
        u: [B, 1] uniforms in [0, 1).
        cdf: [B, D] non-decreasing rows; padded slots hold the total.

    Returns:
        [B] int64 column choices.
    """
    total = cdf[:, -1:]
    choice = (cdf < u * total).sum(dim=-1)
    return torch.clamp(choice, max=cdf.shape[1] - 1)


def categorical_rows(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One column per row proportionally to ``weights`` (padded slots 0).

    The reference's ``searchsorted(cumsum(probs), rand())`` with the
    normalization folded into the draw. Rows summing to 0 return 0
    (callers mask dead walkers out separately).
    """
    return sample_from_cdf(u, torch.cumsum(weights, dim=-1))
