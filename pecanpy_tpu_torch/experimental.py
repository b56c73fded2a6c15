"""Experimental features: node2vec++ continuous bias walks.

Reference ``src/pecanpy/experimental.py:8-102``: Node2vecPlusPlus smooths
the node2vec+ bias factor into a continuous function of w(cur, x) and
w(prev, x); dense container only, as in the reference.

    >>> from pecanpy_tpu_torch.experimental import Node2vecPlusPlus
    >>> g = Node2vecPlusPlus(p=0.5, q=2, device="cuda")
"""
from pecanpy_tpu_torch.models.experimental import Node2vecPlusPlus  # noqa: F401

__all__ = ["Node2vecPlusPlus"]
