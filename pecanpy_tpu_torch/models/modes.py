"""The OTF walk modes, as step-function factories over the shared engine.

Counterpart of ``pecanpy_tpu/models/modes.py`` for ``SparseOTF`` and
``DenseOTF`` on graphs without hubs. The two differ only in which host
container they parse into; both feed the same fused row layout.

Step functions receive the *pre-gathered fused rows* of the current and
previous nodes (carried by the engine) and never touch the node table.
"""
import numpy as np

from pecanpy_tpu_torch.graph import DenseGraph, SparseGraph
from pecanpy_tpu_torch.models.base import Base
from pecanpy_tpu_torch.ops import rejection, sampling, transition
from pecanpy_tpu_torch.ops.layout import (
    DeviceCSR,
    build_device_csr,
    device_csr_from_dense,
)


class _SparseModeBase(Base, SparseGraph):
    """Modes whose host container is the CSR ``SparseGraph``."""

    def _build_device_graph(self) -> DeviceCSR:
        return build_device_csr(
            self.indptr,
            self.indices,
            self.data,
            gamma=self.gamma,
            with_thresholds=self.extend,
            degree_cap=self.degree_cap,
            device=self.device,
        )


class _DenseModeBase(Base, DenseGraph):
    """Modes whose host container is the dense ``DenseGraph``."""

    def _build_device_graph(self) -> DeviceCSR:
        return device_csr_from_dense(
            np.asarray(self.data),
            gamma=self.gamma,
            with_thresholds=self.extend,
            degree_cap=self.degree_cap,
            device=self.device,
        )


def _pick_kernel(extend: bool):
    """Second-order bias function; gamma rides on the device graph."""
    if extend:
        return transition.node2vec_plus_weights_rows
    return transition.node2vec_weights_rows


def _otf_step_fns(p: float, q: float, extend: bool):
    """On-the-fly transition sampling: bias weights + inverse-CDF draw
    (reference OTF move, ``pecanpy.py:543-559``, batched)."""
    kernel = _pick_kernel(extend)

    def first_fn(dg, u, cur, cur_rows):
        x, _ = rejection.propose(dg, u, cur_rows)
        return x

    def step_fn(dg, u, cur, prev, cur_rows, prev_rows):
        weights = kernel(dg, cur_rows, prev_rows, prev, p, q)
        choice = sampling.categorical_rows(u, weights)
        return sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)

    return first_fn, step_fn


class SparseOTF(_SparseModeBase):
    """Compute second-order probabilities on the fly each step (default
    mode; reference ``pecanpy.py:510-561``)."""

    def make_step_fns(self):
        return _otf_step_fns(self.p, self.q, self.extend)


class DenseOTF(_DenseModeBase):
    """OTF walking from a dense adjacency input (reference
    ``pecanpy.py:564-614``): the same transition law as SparseOTF."""

    def make_step_fns(self):
        return _otf_step_fns(self.p, self.q, self.extend)
