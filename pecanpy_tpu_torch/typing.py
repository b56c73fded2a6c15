"""Shared type aliases.

Copied from ``pecanpy_tpu/typing.py`` (importing any ``pecanpy_tpu`` module
pulls in jax, since ``pecanpy_tpu/__init__.py`` imports the models, and the
port must run where jax is absent). The JAX package's ``JaxArray`` alias
has no counterpart: the port's device arrays are ``torch.Tensor``.
"""
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# Host-side array aliases ----------------------------------------------------
Uint32Array = np.ndarray  # dtype uint32
Uint64Array = np.ndarray  # dtype uint64
Float32Array = np.ndarray  # dtype float32
AdjMat = np.ndarray  # 2-D float adjacency matrix
AdjNonZeroMat = np.ndarray  # 2-D bool nonzero mask

# CSR triple: (indptr uint32, indices uint32, data float32)
CSR = Tuple[Uint32Array, Uint32Array, Float32Array]

# Final embedding matrix: float32, shape [num_nodes, dim]
Embeddings = np.ndarray

# Walk-callback aliases (reference: ``src/pecanpy/typing.py:19-21``).
# ``Base.get_has_nbrs`` / ``Base.get_move_forward`` return these shapes;
# the batch engines never use scalar callbacks.
HasNbrs = Callable[[int], bool]
MoveForward = Callable[..., int]

__all__ = [
    "HasNbrs",
    "MoveForward",
    "Any",
    "Callable",
    "Dict",
    "Iterator",
    "List",
    "Optional",
    "Sequence",
    "Tuple",
    "Uint32Array",
    "Uint64Array",
    "Float32Array",
    "AdjMat",
    "AdjNonZeroMat",
    "CSR",
    "Embeddings",
]
