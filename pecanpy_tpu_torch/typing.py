"""Shared type aliases.

Copied (the subset the port uses) from ``pecanpy_tpu/typing.py``:
importing any ``pecanpy_tpu`` module pulls in jax
(``pecanpy_tpu/__init__.py`` imports the models), and the port must run
where jax is absent.
"""
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# Host-side array aliases ----------------------------------------------------
Uint32Array = np.ndarray  # dtype uint32
Float32Array = np.ndarray  # dtype float32
AdjMat = np.ndarray  # 2-D float adjacency matrix

# CSR triple: (indptr uint32, indices uint32, data float32)
CSR = Tuple[Uint32Array, Uint32Array, Float32Array]

# Final embedding matrix: float32, shape [num_nodes, dim]
Embeddings = np.ndarray

__all__ = [
    "Dict",
    "Iterator",
    "List",
    "Optional",
    "Sequence",
    "Tuple",
    "Uint32Array",
    "Float32Array",
    "AdjMat",
    "CSR",
    "Embeddings",
]
