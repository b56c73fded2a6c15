"""Experimental walk modes (counterpart of ``pecanpy_tpu/models/experimental.py``)."""
from pecanpy_tpu_torch.models.modes import _DenseModeBase
from pecanpy_tpu_torch.ops import sampling, transition
from pecanpy_tpu_torch.ops.layout import DeviceCSR, device_csr_from_dense


class Node2vecPlusPlus(_DenseModeBase):
    """Continuous node2vec++ bias walks (experimental).

    Reference ``experimental.py:8-102``: every second-order step draws
    from the continuous bias of ``transition.node2vec_pp_weights_rows``;
    first steps are plain first-order. Always reads the noise thresholds
    (whatever ``extend`` says); dense-only, so fused rows stay uncapped.
    """

    def _build_device_graph(self, device=None) -> DeviceCSR:
        return device_csr_from_dense(
            self.data, gamma=self.gamma, with_thresholds=True,
            degree_cap=None, device=device or self.device,
        )

    def make_step_fns(self):
        p, q = self.p, self.q

        def first_fn(dg, u, cur, cur_rows):
            weights = transition.first_order_weights_rows(dg, cur_rows)
            choice = sampling.categorical_rows(u, weights)
            return sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)

        def step_fn(dg, u, cur, prev, cur_rows, prev_rows):
            weights = transition.node2vec_pp_weights_rows(
                dg, cur_rows, prev_rows, prev, p, q
            )
            choice = sampling.categorical_rows(u, weights)
            return sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)

        return first_fn, step_fn
