"""Chung-Lu power-law undirected weighted graph as a sorted CSR triple.

The construction of ``benchmarks/bench_powerlaw.py:build_powerlaw_graph``
(undirected), rewritten in torch to run on the card (numpy's version
takes tens of seconds of every run's set-up on the H100's host), with one
change: the expected-degree weights are the Pareto(exponent - 1)
quantiles at (i + 0.5) / n, the same sizes for every seed, given to the
nodes in an order drawn from the seed. The original draws them from the
seed, and the heaviest of 1M Pareto(1.2) draws swings by several times
between seeds, so each seed would walk a different hub set. Edges as in
the original: ``n * avg_degree / 2`` endpoint pairs with probability
proportional to the weights, self-loops dropped, each undirected edge
stored both ways once, deterministic symmetric weights in [0.5, 2.0)
from the endpoint pair.
"""
import torch

from harness.csr import symmetric_csr


def generate(seed: int, num_nodes: int, avg_degree: int, exponent: float, device="cpu"):
    """(indptr [n + 1], indices [nnz], data [nnz] float32) host numpy."""
    n = num_nodes
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    quantiles = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    w = (1.0 - quantiles) ** (-1.0 / (exponent - 1.0))
    w = w[torch.randperm(n, generator=gen, device=device)]
    cdf = torch.cumsum(w / w.sum(), 0)
    m = n * avg_degree // 2

    def ends():
        u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        return torch.clamp(torch.searchsorted(cdf, u), max=n - 1)

    src = ends()
    dst = ends()
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return symmetric_csr(torch.cat([src, dst]), torch.cat([dst, src]), n)
