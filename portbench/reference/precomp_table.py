"""Plain reference of PreComp's tables: the node2vec transition CDF of
every directed edge, and the first-order CDF of every node.

The definition (node2vec, Grover & Leskovec 2016, section 3.2.2, as
PecanPy's PreComp precomputes it, Liu & Krishnan, Bioinformatics 2021):
a walker at u that came from x moves to a neighbour v of u with
probability proportional to w(u, v) * alpha, alpha = 1/p if v == x, 1 if
v is a neighbour of x (an entry x -> v of the CSR), 1/q otherwise. The
first step from u moves to v proportionally to w(u, v).

Built here from the benchmark's own CSR triple, in float64, in blocks of
edges or nodes so that it runs at a million nodes on the card. Nothing
here imports the port: every row is worked out again from the triple.

Departures from the paper's definition, each the program's layout:

* a row is the inclusive cumulative distribution over u's neighbours in
  ascending id order (slot j: the probability of moving to one of the
  first j + 1), not the probabilities themselves;
* slots past u's degree (padding) saturate at exactly 1.0;
* a row holds its first ``width`` slots: a node of higher degree keeps
  only the first ``width`` values of its CDF (the program walks such a
  node on the fly instead of reading the row);
* edge e = (u, x), the e-th entry of the row-sorted CSR, addresses the
  row "at u, came from x". Every entry has a row, also on a directed
  graph where x -> u is no entry and no walker arrives at u from x;
* a node without neighbours has a first-order row of 0.0: its total is
  0, there is no distribution, and no walker draws from it;
* weights are the CSR's float32 values, combined in float64.
"""
import numpy as np
import torch

# Half the distance from 1.0 to the next float32 (2**-24): a unit of the
# rounding bounds below.
F32_UNIT = 2.0 ** -24


def f32_cdf_atol(terms: int) -> float:
    """Largest gap a float32 CDF row of at most ``terms`` non-zero
    summands may have from the exact one, computed as the program
    computes it: each weight times a rounded 1/p or 1/q (relative error
    at most 2 units), a prefix sum in any order (the sum of k terms off
    by at most k - 1 units of itself), one division by the row's total
    (1 unit). For slot k of n terms, k <= n: |c - c_exact| <= c * ((k + 1)
    + (n + 1) + 1) units, and c <= 1, so 2n + 3 units bound every slot; one
    more unit covers a division that is not correctly rounded. At 64
    terms that is 132 units, 66 ulps of 1.0."""
    return (2 * int(terms) + 4) * F32_UNIT


# The first-order channel is computed in float64 and rounded once to
# float32: half an ulp of 1.0 at most, and float64's own error far below.
F32_ROUNDED_ATOL = 2 * F32_UNIT


class PrecompReference:
    """The CSR triple, rows sorted by column, with its edge keys sorted
    for neighbour tests."""

    def __init__(self, indptr, indices, data, p: float, q: float, device="cpu"):
        indptr = np.asarray(indptr, dtype=np.int64)
        self.n = int(indptr.size - 1)
        self.p, self.q = float(p), float(q)
        self.device = torch.device(device)
        deg = np.diff(indptr)
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        keys = src * self.n + np.asarray(indices, dtype=np.int64)
        order = np.argsort(keys, kind="stable")  # sorts each row by column
        to = dict(device=self.device)
        self.keys = torch.from_numpy(keys[order]).to(**to)
        self.col = self.keys % self.n
        self.wgt = torch.from_numpy(np.asarray(data, dtype=np.float32)[order]).to(
            **to).to(torch.float64)
        self.src = torch.from_numpy(src).to(**to)
        self.indptr = torch.from_numpy(indptr).to(**to)
        self.deg = torch.from_numpy(deg).to(**to)

    @property
    def num_edges(self) -> int:
        return int(self.keys.numel())

    @property
    def max_degree(self) -> int:
        return int(self.deg.max()) if self.n else 0

    def is_edge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Is a -> b an entry of the CSR, for int64 node tensors."""
        key = a * self.n + b
        pos = torch.clamp(torch.searchsorted(self.keys, key), max=self.keys.numel() - 1)
        return self.keys[pos] == key

    def _row_slots(self, u: torch.Tensor):
        """[b, D] neighbours and weights of the nodes ``u`` (D their largest
        degree; -1 and 0 past a row's end) and the mask of real slots."""
        deg = self.deg[u]
        d = max(int(deg.max()) if deg.numel() else 0, 1)
        j = torch.arange(d, device=self.device)
        real = j[None, :] < deg[:, None]
        e = torch.where(real, self.indptr[u][:, None] + j[None, :], 0)
        v = torch.where(real, self.col[e], -1)
        w = torch.where(real, self.wgt[e], 0.0)
        return v, w, real

    @staticmethod
    def _cdf(pw: torch.Tensor, real: torch.Tensor, width: int):
        """Inclusive CDF rows of the weights ``pw`` cut or padded to
        ``width`` slots, and the mask of their padding slots, which hold
        exactly 1.0 (a row without weight is 0.0 and has none)."""
        cdf = torch.cumsum(pw, dim=1)
        total = cdf[:, -1:]  # the last slot is total / total, exactly 1.0
        some = total > 0
        cdf = torch.where(real, cdf / torch.where(some, total, 1.0), some.to(cdf.dtype))
        pad = ~real & some
        if cdf.shape[1] >= width:
            return cdf[:, :width], pad[:, :width]
        more = width - cdf.shape[1]
        return (torch.cat([cdf, some.to(cdf.dtype).expand(-1, more)], dim=1),
                torch.cat([pad, some.expand(-1, more)], dim=1))

    def edge_rows(self, lo: int, hi: int, width: int):
        """[hi - lo, width] float64 CDF rows of edges lo..hi-1, out of u
        given the walker came from x for each edge (u, x), and their
        padding mask."""
        u, x = self.src[lo:hi], self.col[lo:hi]
        v, w, real = self._row_slots(u)
        xs = x[:, None].expand_as(v)
        common = real & self.is_edge(torch.where(real, xs, 0), torch.where(real, v, 0))
        alpha = torch.where(v == xs, 1.0 / self.p, torch.where(common, 1.0, 1.0 / self.q))
        return self._cdf(w * alpha, real, width)

    def node_rows(self, lo: int, hi: int, width: int):
        """[hi - lo, width] float64 first-order CDF rows of nodes lo..hi-1,
        and their padding mask."""
        _, w, real = self._row_slots(torch.arange(lo, hi, device=self.device))
        return self._cdf(w, real, width)


def table_gaps(rows_fn, table: torch.Tensor, block: int = 1 << 20):
    """Hold a program table [R, w] to the reference rows ``rows_fn(lo, hi,
    w)``, block by block on the reference's device. Returns the largest
    gap at a slot that is no padding, and the padding slots where the
    program's value is not exactly 1.0."""
    rows, width = table.shape
    worst, pad_faults = 0.0, 0
    for lo in range(0, rows, block):
        hi = min(lo + block, rows)
        ref, pad = rows_fn(lo, hi, width)
        got = table[lo:hi].to(ref.device, torch.float64)
        gap = torch.where(pad, 0.0, (got - ref).abs())
        worst = max(worst, float(gap.max()))
        pad_faults += int((pad & (got != 1.0)).sum())
    return worst, pad_faults
