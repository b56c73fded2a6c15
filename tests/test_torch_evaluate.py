"""The port's evaluation protocol against ``pecanpy_tpu/utils/evaluate.py``.

The synthetic benchmark graph is numpy in both packages and must agree to
the bit. The one-vs-rest classifier trains with torch here and with a
jitted JAX loop there, both in float32 over the same 300 gradient steps:
its weights agree within rtol 1e-4, atol 1e-5, and the protocol's
micro-F1 within 1e-3.
"""
import numpy as np
import pytest

from pecanpy_tpu.utils import evaluate as jevaluate
from pecanpy_tpu_torch.utils import evaluate


def test_overlapping_sbm_bit_equal():
    port = evaluate.overlapping_sbm(n=600, n_communities=8, mean_degree=20.0, seed=3)
    ref = jevaluate.overlapping_sbm(n=600, n_communities=8, mean_degree=20.0, seed=3)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    indptr, _, _, labels = port
    assert (np.diff(indptr) > 0).all() and labels.sum(1).min() >= 1


def test_train_ovr_logistic_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = rng.random((400, 6)) < 0.3
    w, b = evaluate.train_ovr_logistic(x, y, device="cpu")
    w_ref, b_ref = jevaluate.train_ovr_logistic(x, y)
    assert w.dtype == np.float32 and w.shape == (16, 6) and b.shape == (6,)
    np.testing.assert_allclose(w, w_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b, b_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("source", ["structured", "random"])
def test_multilabel_node_classification_matches_jax(source):
    """The protocol's micro-F1 on embeddings that carry the labels (with
    noise) and on random ones (the floor)."""
    _, _, _, labels = evaluate.overlapping_sbm(n=600, n_communities=8, seed=3)
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((600, 32)).astype(np.float32)
    if source == "structured":
        emb[:, :8] += 2.0 * labels
    f1 = evaluate.multilabel_node_classification(emb, labels, seed=0, device="cpu")
    f1_ref = jevaluate.multilabel_node_classification(emb, labels, seed=0)
    assert abs(f1 - f1_ref) <= 1e-3
    assert (f1 > 0.6) if source == "structured" else (f1 < 0.4)
