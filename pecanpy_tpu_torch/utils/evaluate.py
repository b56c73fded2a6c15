"""Downstream evaluation: the node2vec-paper node-classification protocol.

Copied from ``pecanpy_tpu/utils/evaluate.py`` (that package cannot be
imported without jax). The published BlogCatalog benchmark (node2vec
paper section 4.3) scores embeddings with **multi-label one-vs-rest
logistic regression**: train L2-regularized logistic classifiers on a
fraction of nodes, and for each test node predict its top-k labels where
k is the node's true label count, then report micro-F1. The classifier
trains with torch on an explicit ``device`` (the JAX version runs a
jitted loop); the split, the normalisation, the prediction, the score
and the synthetic benchmark graph stay numpy, as there.
"""
from typing import Tuple

import numpy as np
import torch

from pecanpy_tpu_torch.models.base import resolve_device


def train_ovr_logistic(
    x: np.ndarray,
    y: np.ndarray,
    l2: float = 1e-4,
    epochs: int = 300,
    lr: float = 0.5,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """One-vs-rest logistic regression by full-batch gradient descent, in
    float32 on ``device`` (the same steps as the JAX version).

    Args:
        x: [N, D] features (embeddings).
        y: [N, C] binary label matrix.
        device: torch device; "cuda" (the default) raises without one.

    Returns (W [D, C], b [C]) as numpy arrays.
    """
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    n = x.shape[0]
    w = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32, device=device)
    b = torch.zeros((y.shape[1],), dtype=torch.float32, device=device)
    for _ in range(epochs):
        p = torch.sigmoid(x @ w + b)
        g = (p - y) / n  # [N, C]
        gw = x.T @ g + l2 * w
        gb = g.sum(dim=0)
        w = w - lr * gw
        b = b - lr * gb
    return w.cpu().numpy(), b.cpu().numpy()


def topk_multilabel_predict(
    scores: np.ndarray, k_per_node: np.ndarray
) -> np.ndarray:
    """Binary predictions: each node's top-k_i scored labels (the
    node2vec-paper convention — the evaluator knows the label count)."""
    n, c = scores.shape
    pred = np.zeros((n, c), dtype=bool)
    order = np.argsort(-scores, axis=1)
    for i in range(n):
        pred[i, order[i, : int(k_per_node[i])]] = True
    return pred


def micro_f1(pred: np.ndarray, true: np.ndarray) -> float:
    """Micro-averaged F1 over all (node, label) decisions."""
    tp = float(np.sum(pred & true))
    fp = float(np.sum(pred & ~true))
    fn = float(np.sum(~pred & true))
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)


def multilabel_node_classification(
    embeddings: np.ndarray,
    labels: np.ndarray,
    train_fraction: float = 0.5,
    seed: int = 0,
    l2: float = 1e-4,
    epochs: int = 300,
    device="cuda",
) -> float:
    """Full protocol: split -> OvR logistic -> top-k predict -> micro-F1.

    Args:
        embeddings: [N, D] node embeddings (graph-aligned).
        labels: [N, C] binary multi-label matrix.
        train_fraction: labeled fraction (the papers sweep 10%-90%;
            50% is the headline point).
        device: where the classifier trains (``train_ovr_logistic``).

    Returns micro-F1 on the held-out nodes.
    """
    labels = np.asarray(labels, dtype=bool)
    n = embeddings.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(train_fraction * n)
    tr, te = perm[:n_train], perm[n_train:]
    # normalized embeddings (standard practice for the protocol)
    x = embeddings / np.maximum(
        np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12
    )
    w, b = train_ovr_logistic(
        x[tr], labels[tr], l2=l2, epochs=epochs, device=device
    )
    scores = x[te] @ w + b
    k = labels[te].sum(axis=1)
    pred = topk_multilabel_predict(scores, k)
    return micro_f1(pred, labels[te])


def overlapping_sbm(
    n: int,
    n_communities: int,
    mean_degree: float = 30.0,
    labels_per_node: Tuple[int, int] = (1, 3),
    p_in_out_ratio: float = 20.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic multi-label benchmark: overlapping stochastic block model.

    Nodes carry 1-3 community labels; edge probability scales with the
    number of shared communities — the structural analogue of
    BlogCatalog's overlapping social groups (multi-label, one-vs-rest
    territory; single-label accuracy proxies do not apply).

    Returns (indptr, indices, data, labels [N, C] bool) as a sorted CSR.
    """
    rng = np.random.default_rng(seed)
    lo, hi = labels_per_node
    n_labels = rng.integers(lo, hi + 1, size=n)
    labels = np.zeros((n, n_communities), dtype=bool)
    for i in range(n):
        labels[i, rng.choice(n_communities, size=n_labels[i], replace=False)] = True

    # expected edges ~ n * mean_degree / 2; sample candidate pairs and
    # keep by shared-community weighting
    m_cand = int(n * mean_degree * 2)
    u = rng.integers(0, n, m_cand)
    v = rng.integers(0, n, m_cand)
    keep_mask = u != v
    u, v = u[keep_mask], v[keep_mask]
    shared = (labels[u] & labels[v]).sum(axis=1)
    base = 1.0 / p_in_out_ratio
    accept = rng.random(u.size) < (base + shared) / (base + hi)
    # thin to the target edge count, preferring in-community pairs
    u, v = u[accept], v[accept]
    target = int(n * mean_degree / 2)
    if u.size > target:
        u, v = u[:target], v[:target]
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    code = np.unique(uu.astype(np.int64) * n + vv)
    uu, vv = code // n, code % n
    deg = np.bincount(uu, minlength=n)
    # connect isolated nodes to a random peer so walks exist everywhere
    isolated = np.nonzero(deg == 0)[0]
    if isolated.size:
        peers = rng.integers(0, n, isolated.size)
        peers = np.where(peers == isolated, (peers + 1) % n, peers)
        uu = np.concatenate([uu, isolated, peers])
        vv = np.concatenate([vv, peers, isolated])
        code = np.unique(uu.astype(np.int64) * n + vv)
        uu, vv = code // n, code % n
        deg = np.bincount(uu, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    data = np.ones(vv.size, dtype=np.float32)
    return indptr.astype(np.int64), vv.astype(np.int64), data, labels
