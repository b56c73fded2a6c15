"""The CSR triple the graph generators hand out."""
import torch


def symmetric_csr(u: torch.Tensor, v: torch.Tensor, n: int):
    """Arcs (u, v), both directions of every edge given, deduplicated and
    sorted into (indptr [n + 1] int64, indices int64, data float32) host
    numpy arrays; weights deterministic in [0.5, 2.0) from the unordered
    endpoint pair, as ``bench.py`` and ``bench_powerlaw.py`` weigh them."""
    code = torch.unique(u * n + v)  # sorted: rows ascending, columns within
    u, v = code // n, code % n
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    w = (((lo * 2654435761 + hi) % 1000).double() / 1000.0 * 1.5 + 0.5).to(torch.float32)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=u.device)
    indptr[1:] = torch.cumsum(torch.bincount(u, minlength=n), 0)
    return indptr.cpu().numpy(), v.cpu().numpy(), w.cpu().numpy()
