"""Mode classes under the reference module path.

    >>> from pecanpy_tpu_torch import pecanpy
    >>> g = pecanpy.PreComp(p=0.5, q=2, device="cuda")

The experimental ``Node2vecPlusPlus`` lives in ``pecanpy_tpu_torch.experimental``.
"""

from pecanpy_tpu_torch.models.base import Base  # noqa: F401
from pecanpy_tpu_torch.models.modes import (  # noqa: F401
    DenseOTF,
    FirstOrderUnweighted,
    PreComp,
    PreCompFirstOrder,
    SparseOTF,
)

__all__ = [
    "Base",
    "DenseOTF",
    "FirstOrderUnweighted",
    "PreComp",
    "PreCompFirstOrder",
    "SparseOTF",
]
