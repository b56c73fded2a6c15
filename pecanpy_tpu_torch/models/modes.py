"""The OTF walk modes, as step-function factories over the shared engines.

Counterpart of ``pecanpy_tpu/models/modes.py`` for ``SparseOTF`` and
``DenseOTF``. The two differ only in which host container they parse
into; both feed the same fused row layout. Graphs without hubs walk with
the scan engine over the step functions below; graphs with hubs walk
with the hub engines (``_AmortizedOTFMixin``).

Step functions receive the *pre-gathered fused rows* of the current and
previous nodes (carried by the engine) and never touch the node table.
"""
import os

import numpy as np

from pecanpy_tpu_torch.graph import DenseGraph, SparseGraph
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.models.base import ROADMAP_SLICES, Base
from pecanpy_tpu_torch.ops import rejection, sampling, transition
from pecanpy_tpu_torch.ops.layout import (
    LANE,
    DeviceCSR,
    build_device_csr,
    device_csr_from_dense,
)


def _want_cdf(num_nodes: int, max_degree: int, degree_cap) -> bool:
    """Should this graph carry the first-order CDF channel?

    The hub walkers' capped-row proposal reads it instead of a prefix sum
    of the wgt row every trial, so hub graphs get it within a budget of
    N * dpad * 4 bytes (default 2 GiB, ``PECANPY_TPU_CDF_BUDGET_MB``; 0
    disables). Graphs without hubs walk with the scan engine, which has no
    use for it (``pecanpy_tpu/models/modes.py:_want_cdf``).
    """
    if degree_cap is None or max_degree <= degree_cap:
        return False
    budget = int(os.environ.get("PECANPY_TPU_CDF_BUDGET_MB", "2048")) * (1 << 20)
    dpad = -(-min(max_degree, degree_cap) // LANE) * LANE
    return num_nodes * dpad * 4 <= budget


class _SparseModeBase(Base, SparseGraph):
    """Modes whose host container is the CSR ``SparseGraph``."""

    def _build_device_graph(self) -> DeviceCSR:
        deg_max = int(np.diff(self.indptr).max()) if self.num_edges else 0
        return build_device_csr(
            self.indptr,
            self.indices,
            self.data,
            gamma=self.gamma,
            with_thresholds=self.extend,
            with_cdf=_want_cdf(self.num_nodes, deg_max, self.degree_cap),
            degree_cap=self.degree_cap,
            device=self.device,
        )


class _DenseModeBase(Base, DenseGraph):
    """Modes whose host container is the dense ``DenseGraph``."""

    def _build_device_graph(self) -> DeviceCSR:
        dense = np.asarray(self.data)
        nonzero_per_row = (dense != 0).sum(axis=1)
        deg_max = int(nonzero_per_row.max()) if nonzero_per_row.size else 0
        return device_csr_from_dense(
            dense,
            gamma=self.gamma,
            with_thresholds=self.extend,
            with_cdf=_want_cdf(dense.shape[0], deg_max, self.degree_cap),
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


class _AmortizedOTFMixin:
    """Routes hub graphs through the hub walkers.

    The queued engine (``engine.generate_walks_queued``) is the default;
    ``PECANPY_TPU_QUEUE_FACTOR=0`` takes the per-batch amortized engine.
    ``PECANPY_TPU_AMORTIZED_TRIALS`` (default 2) sets the trials per
    round, ``PECANPY_TPU_UNROLL`` (default 4) the rounds per host read
    of the pending count: ``UNROLL`` in the amortized engine, ``4 *
    UNROLL`` in the queued one (the JAX engine's ``unroll *
    flush_every``). Graphs without hubs keep the scan engine. The JAX
    package's per-step rejection sampler (``PECANPY_TPU_AMORTIZED=0``)
    is not ported: on a hub graph that setting raises.
    """

    def _walk_queue_factor(self) -> int:
        """Walks per chunk = queue_factor * walker lanes (hub graphs): the
        queued engine amortizes its straggler tail over the whole chunk
        (``PECANPY_TPU_QUEUE_FACTOR``, default 8; 0 takes the per-batch
        amortized engine, one batch per chunk)."""
        if not self.get_device_graph().has_hubs:
            return 1
        return max(int(os.environ.get("PECANPY_TPU_QUEUE_FACTOR", "8")), 1)

    def _make_walk_runner(self, walk_length: int):
        if not self.get_device_graph().has_hubs:
            return super()._make_walk_runner(walk_length)
        if os.environ.get("PECANPY_TPU_AMORTIZED", "1") in ("0", "false"):
            raise NotImplementedError(
                "PECANPY_TPU_AMORTIZED=0 on a graph with hubs needs the "
                "per-step rejection sampler, which is not ported yet "
                f"({ROADMAP_SLICES}, item 19)"
            )
        p, q, extend = self.p, self.q, self.extend
        trials = int(os.environ.get("PECANPY_TPU_AMORTIZED_TRIALS", "2"))
        unroll = int(os.environ.get("PECANPY_TPU_UNROLL", "4"))
        queued = os.environ.get("PECANPY_TPU_QUEUE_FACTOR", "8") != "0"
        lanes = self._resolved_walker_batch()

        def run(dg, start, chunk_idx):
            draws = engine.TrialDrawStream(self._seed(), chunk_idx, trials, self.device)
            if queued:
                return engine.generate_walks_queued(
                    dg, start, draws, walk_length, p, q, extend, lanes=lanes,
                    block_rounds=4 * unroll,
                )
            return engine.generate_walks_amortized(
                dg, start, draws, walk_length, p, q, extend, unroll=unroll
            )

        return run


class SparseOTF(_AmortizedOTFMixin, _SparseModeBase):
    """Compute second-order probabilities on the fly each step (default
    mode; reference ``pecanpy.py:510-561``)."""

    def make_step_fns(self):
        return _otf_step_fns(self.p, self.q, self.extend)


class DenseOTF(_AmortizedOTFMixin, _DenseModeBase):
    """OTF walking from a dense adjacency input (reference
    ``pecanpy.py:564-614``): the same transition law as SparseOTF."""

    def make_step_fns(self):
        return _otf_step_fns(self.p, self.q, self.extend)
