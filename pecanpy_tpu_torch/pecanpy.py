"""Mode classes under the reference module path.

    >>> from pecanpy_tpu_torch import pecanpy
    >>> g = pecanpy.SparseOTF(p=0.5, q=2, device="cuda")

Only the OTF modes are ported so far; the others are listed in ROADMAP.md.
"""

from pecanpy_tpu_torch.models.modes import DenseOTF, SparseOTF  # noqa: F401

__all__ = ["DenseOTF", "SparseOTF"]
