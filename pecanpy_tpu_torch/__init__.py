"""pecanpy-tpu on PyTorch and CUDA: node2vec walks and SGNS on one GPU.

The port of ``pecanpy_tpu`` (JAX, TPU) to PyTorch, with every Pallas
kernel of the JAX package rewritten as a hand-written CUDA kernel for
Hopper: the sparse-row table applier (``csrc/apply.cu``), its windowed
variant (``csrc/apply_v2.cu``) and the two rejection-trial kernels of
the hub walkers (``csrc/trial.cu``). It imports torch and numpy, never
jax; the JAX package stays the reference it is tested against.

    >>> from pecanpy_tpu_torch import pecanpy
    >>> g = pecanpy.SparseOTF(p=1, q=1, device="cuda")
    >>> g.read_edg("karate.edg", weighted=False, directed=False)
    >>> emb = g.embed(dim=128)
"""

from pecanpy_tpu_torch import graph  # noqa: F401
from pecanpy_tpu_torch import pecanpy  # noqa: F401

__version__ = "0.1.0"
__all__ = ["graph", "pecanpy", "__version__"]
