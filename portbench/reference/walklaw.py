"""Plain reference of a node2vec walk: which steps are edges, and the law.

The graph is the benchmark's own CSR triple (the ``.csr.npz`` both sides
read), held as sorted edge keys ``src * n + dst`` with their weights, so
an edge test is one ``searchsorted``.

The law (node2vec, Grover & Leskovec 2016, as PecanPy's SparseOTF walks
it): the first step from ``cur`` picks neighbour x with probability
proportional to w(cur, x); a later step with previous node ``prev`` picks
x proportional to w(cur, x) * alpha(x), alpha = 1/p for x == prev, 1 for
x a neighbour of prev, 1/q otherwise. A walk stops early only at a node
without neighbours.

node2vec+ (``extend``; Liu, Hirn & Krishnan, Bioinformatics 2023, arXiv
2109.08031, as PecanPy's ``get_extended_normalized_probs`` publishes it)
changes alpha for x != prev. Each node has a noise threshold, the mean of
its edge weights plus gamma times their population standard deviation,
clipped at 0. x is "out" if it is no neighbour of prev, or if w(prev, x)
< thr(x) (a loose common neighbour); it then takes 1/q + (1 - 1/q) *
w(prev, x) / thr(x), with w(prev, x) = 0 for a non-neighbour, or
min(1, 1/q) where the out edge is noisy: w(cur, x) < thr(cur). Every
other x takes 1. The first step is first-order as above.

``law_z`` holds a sample of the walks' steps to that law. For each test
function f of a step (a return to prev, a move to a common neighbour of
prev, a move out, the weight of the edge taken; under node2vec+ also a
move along a noisy out edge, the rule that sets it apart) the sum over
the sample of f(observed) - E[f] is a martingale under the law, so
z_f = that sum / sqrt(sum of Var[f]) is close to a standard normal for
walks drawn from the law, and grows with the sample for walks drawn from
another law.
"""
import numpy as np
import torch

STAT_NAMES = ("return", "common", "out", "weight", "first_weight")
PLUS_STAT = "noisy_out"  # node2vec+ only


class RefGraph:
    """The benchmark's CSR triple as sorted edge keys on ``device``."""

    def __init__(self, indptr, indices, data, device):
        indptr = np.asarray(indptr, dtype=np.int64)
        self.n = int(indptr.size - 1)
        deg = np.diff(indptr)
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        keys = torch.from_numpy(src * self.n + np.asarray(indices, dtype=np.int64)).to(device)
        wgt = torch.from_numpy(np.asarray(data, dtype=np.float32)).to(device)
        keys, order = torch.sort(keys)
        self.keys, self.wgt = keys, wgt[order].to(torch.float64)
        self.col = keys % self.n
        self.deg = torch.from_numpy(deg).to(device)
        self.indptr = torch.from_numpy(indptr).to(device)
        self.device = device

    def thresholds(self, gamma: float) -> torch.Tensor:
        """[n] float64 node2vec+ noise thresholds: the mean of each node's
        edge weights plus ``gamma`` times their population standard
        deviation, clipped at 0 (0 for a node without edges)."""
        f64 = dict(dtype=torch.float64, device=self.device)
        node = torch.repeat_interleave(torch.arange(self.n, device=self.device), self.deg)
        deg = torch.clamp(self.deg, min=1).to(torch.float64)
        mean = torch.zeros(self.n, **f64).index_add_(0, node, self.wgt) / deg
        var = torch.zeros(self.n, **f64).index_add_(0, node, (self.wgt - mean[node]) ** 2)
        thr = torch.clamp(mean + gamma * torch.sqrt(var / deg), min=0.0)
        return torch.where(self.deg > 0, thr, 0.0)

    def lookup(self, a: torch.Tensor, b: torch.Tensor):
        """(is an edge a -> b, its weight or 0) for int64 node tensors."""
        key = a * self.n + b
        pos = torch.clamp(torch.searchsorted(self.keys, key), max=self.keys.numel() - 1)
        found = self.keys[pos] == key
        return found, torch.where(found, self.wgt[pos], torch.zeros((), dtype=torch.float64,
                                                                     device=self.device))


def check_walks(g: RefGraph, walks: torch.Tensor, eff: torch.Tensor, block: int = 1 << 16):
    """Faults in a walk matrix: steps that are not edges, walks that stop
    early at a node with neighbours or run past their end, and lengths
    out of range. Returns the number of faulty walks."""
    bad = 0
    w_all, e_all = walks.to(g.device), eff.to(g.device)
    t = walks.shape[1]
    for lo in range(0, walks.shape[0], block):
        w = w_all[lo:lo + block].long()
        e = e_all[lo:lo + block].long()
        out_of_range = (e < 1) | (e > t) | (w[:, 0] < 0) | (w[:, 0] >= g.n)
        e = torch.clamp(e, 1, t)
        a, b = w[:, :-1], w[:, 1:]
        inside = torch.arange(1, t, device=g.device)[None] < e[:, None]
        ok_nodes = (b >= 0) & (b < g.n) & (a >= 0) & (a < g.n)
        found, _ = g.lookup(torch.where(ok_nodes, a, 0), torch.where(ok_nodes, b, 0))
        bad_step = (inside & ~(found & ok_nodes)).any(dim=1)
        last = w.gather(1, (e - 1)[:, None])[:, 0].clamp(0, g.n - 1)
        early = (e < t) & (g.deg[last] > 0)
        bad += int((out_of_range | bad_step | early).sum())
    return bad


def check_starts(g: RefGraph, walks: torch.Tensor, num_walks: int) -> int:
    """Nodes that do not start exactly ``num_walks`` walks."""
    starts = walks[:, 0].to(g.device).long().clamp(0, g.n - 1)
    counts = torch.bincount(starts, minlength=g.n)
    return int((counts != num_walks).sum()) + int((walks[:, 0] >= g.n).sum())


def sample_steps(walks: torch.Tensor, eff: torch.Tensor, size: int, seed: int):
    """``size`` steps (row, position >= 1 inside the walk) drawn from the
    seed, uniformly over rows that took a step. Host int64 arrays."""
    rng = np.random.default_rng(seed)
    eff_h = eff.cpu().numpy().astype(np.int64)
    movable = np.flatnonzero(eff_h >= 2)
    if movable.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rows = movable[rng.integers(0, movable.size, size)]
    pos = 1 + (rng.random(size) * (eff_h[rows] - 1)).astype(np.int64)
    return rows, pos


def _plus_bias(w, wpx, common, thr_x, thr_cur, q):
    """node2vec+'s alpha of candidates x that are not prev, and whether
    each is a noisy out edge: ``w`` = w(cur, x), ``wpx`` = w(prev, x) (0
    where ``common`` is false), thresholds of x and of cur."""
    loose = common & (wpx < thr_x)
    out = ~common | loose
    t = torch.where(loose, wpx / torch.clamp(thr_x, min=1e-300), 0.0)
    inv_q = 1.0 / q
    noisy = out & (w < thr_cur)
    alpha = torch.where(noisy, min(1.0, inv_q),
                        torch.where(out, inv_q + (1.0 - inv_q) * t, 1.0))
    return alpha, noisy


def _stats(g: RefGraph, prev, cur, nxt, p, q, first, max_pairs, thr=None):
    """Per sampled step: observed f and E[f], Var[f] under the law, for
    each test function; (obs [S, F], mean [S, F], var [S, F]). ``thr``:
    the nodes' thresholds for node2vec+'s law (F = 5, the last column a
    move along a noisy out edge), or None for node2vec's (F = 4)."""
    s = cur.numel()
    dev = g.device
    nf = 4 if thr is None else 5
    f_obs = torch.zeros((s, nf), dtype=torch.float64, device=dev)
    m1 = torch.zeros_like(f_obs)
    m2 = torch.zeros_like(f_obs)
    z = torch.zeros(s, dtype=torch.float64, device=dev)
    deg = g.deg[cur]
    # enumerate the neighbours of every step's cur, in blocks of steps
    # whose summed degree stays under max_pairs
    cum = torch.cumsum(deg, 0)
    lo = 0
    while lo < s:
        hi = int(torch.searchsorted(cum, cum[lo] - deg[lo] + max_pairs, right=True))
        hi = max(hi, lo + 1)
        d = deg[lo:hi]
        step = torch.repeat_interleave(torch.arange(lo, hi, device=dev), d)
        start = g.indptr[cur[lo:hi]]
        offs = torch.arange(step.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(d, 0) - d, d)
        e = torch.repeat_interleave(start, d) + offs
        x, w = g.col[e], g.wgt[e]
        pv = prev[step]
        is_ret = (x == pv) & ~first[step]
        common, wpx = g.lookup(pv, x)
        is_common = common & ~is_ret & ~first[step]
        is_out = ~is_ret & ~is_common & ~first[step]
        cols = [is_ret.double(), is_common.double(), is_out.double(), w]
        if thr is None:
            alpha = torch.where(first[step], 1.0, torch.where(is_ret, 1.0 / p, torch.where(
                is_common, 1.0, 1.0 / q)))
        else:
            plus, noisy = _plus_bias(w, wpx, common, thr[x], thr[cur[step]], q)
            alpha = torch.where(first[step], 1.0, torch.where(is_ret, 1.0 / p, plus))
            cols.append((noisy & ~is_ret & ~first[step]).double())
        pw = w * alpha
        z.index_add_(0, step, pw)
        fs = torch.stack(cols, 1)
        m1.index_add_(0, step, pw[:, None] * fs)
        m2.index_add_(0, step, pw[:, None] * fs * fs)
        lo = hi
    m1 = m1 / z[:, None]
    m2 = m2 / z[:, None]
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    found, w_obs = g.lookup(cur, nxt)
    ret_obs = (nxt == prev) & ~first
    common_prev, wpx_obs = g.lookup(prev, nxt)
    common_obs = common_prev & ~ret_obs & ~first
    out_obs = ~ret_obs & ~common_obs & ~first
    cols = [ret_obs.double(), common_obs.double(), out_obs.double(), w_obs]
    if thr is not None:
        _, noisy = _plus_bias(w_obs, wpx_obs, common_prev, thr[nxt.clamp(0, g.n - 1)],
                              thr[cur], q)
        cols.append((noisy & ~ret_obs & ~first).double())
    f_obs = torch.stack(cols, 1)
    return f_obs, m1, var, found


def law_z(g: RefGraph, walks: torch.Tensor, eff: torch.Tensor, p: float, q: float,
          size: int, seed: int, max_pairs: int = 1 << 25, extend: bool = False,
          gamma: float = 0.0):
    """{stat: z} over ``size`` sampled steps of ``walks``, and the number
    of sampled steps that are not edges. ``first_weight`` holds the first
    steps (no prev) to the first-order law; the others hold the later
    steps to the second-order law: node2vec's, or with ``extend``
    node2vec+'s under ``gamma``, which adds ``noisy_out``."""
    rows, pos = sample_steps(walks, eff, size, seed)
    rows_t = torch.from_numpy(rows).to(g.device)
    pos_t = torch.from_numpy(pos).to(g.device)
    w = walks.to(g.device)
    nxt = w[rows_t, pos_t].long()
    cur = w[rows_t, pos_t - 1].long()
    first = pos_t == 1
    prev = torch.where(first, cur, w[rows_t, torch.clamp(pos_t - 2, min=0)].long())
    thr = g.thresholds(gamma) if extend else None
    f_obs, mean, var, found = _stats(g, prev, cur, nxt, p, q, first, max_pairs, thr)
    out = {}
    later = ~first
    names = STAT_NAMES[:4] + ((PLUS_STAT,) if extend else ())
    for k, name in enumerate(names):
        out[name] = _z(f_obs[later, k], mean[later, k], var[later, k])
    out["first_weight"] = _z(f_obs[first, 3], mean[first, 3], var[first, 3])
    return out, int((~found).sum())


def _z(obs, mean, var) -> float:
    v = float(var.sum())
    if v <= 0:
        return 0.0
    return float((obs - mean).sum()) / v ** 0.5
