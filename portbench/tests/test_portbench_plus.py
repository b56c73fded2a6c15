"""node2vec+ in the benchmark: the configuration names the walk's variant,
the plain reference holds node2vec+'s law, and ``powerlaw1m.walks_plus``
runs through the harness on the CPU.

The law is checked against a plain loop over the paper's definition
(Liu, Hirn & Krishnan, arXiv 2109.08031, as PecanPy's
``get_extended_normalized_probs`` publishes it), written here apart from
``reference/walklaw.py``; node2vec's law keeps the arithmetic it had
before node2vec+ came in, to the bit.
"""
import math

import numpy as np
import pytest
import torch

from harness import cells, entries, runner
from reference import walklaw

SEED = 2**31 + 1201
CELL = "powerlaw1m.walks_plus"


def weighted_graph(n=60, p_edge=0.2, seed=4):
    """A small undirected graph dense enough for many common neighbours,
    with weights spread wide enough for loose and noisy edges."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p_edge, 1)
    wts = np.triu(rng.uniform(0.1, 3.0, (n, n)), 1)
    adj = upper | upper.T
    w = np.where(adj, wts + wts.T, 0.0).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(adj.sum(1))]).astype(np.int64)
    indices = np.concatenate([np.flatnonzero(adj[i]) for i in range(n)]).astype(np.int64)
    data = np.concatenate([w[i, adj[i]] for i in range(n)]).astype(np.float32)
    return indptr, indices, data


class PlainLaw:
    """node2vec+'s transition law by a loop over the definition."""

    def __init__(self, indptr, indices, data, p, q, gamma):
        self.p, self.q = p, q
        self.nbrs = [indices[indptr[i]:indptr[i + 1]].tolist() for i in range(len(indptr) - 1)]
        self.w = [dict(zip(self.nbrs[i], data[indptr[i]:indptr[i + 1]].astype(float).tolist()))
                  for i in range(len(self.nbrs))]
        self.thr = []
        for ws in self.w:
            vals = list(ws.values())
            if not vals:
                self.thr.append(0.0)
                continue
            mean = sum(vals) / len(vals)
            std = math.sqrt(sum((v - mean) ** 2 for v in vals) / len(vals))
            self.thr.append(max(mean + gamma * std, 0.0))

    def kinds(self, prev, cur, x):
        """(return, common, out, noisy out) of the move cur -> x after prev."""
        ret = x == prev
        common = not ret and x in self.w[prev]
        wpx = self.w[prev].get(x, 0.0)
        out_plus = not ret and (x not in self.w[prev] or wpx < self.thr[x])
        noisy = out_plus and self.w[cur][x] < self.thr[cur]
        return ret, common, not ret and not common, noisy

    def probs(self, prev, cur):
        """{x: probability} of the step from cur after prev (None: first)."""
        out = {}
        for x in self.nbrs[cur]:
            w = self.w[cur][x]
            if prev is None:
                alpha = 1.0
            elif x == prev:
                alpha = 1.0 / self.p
            else:
                wpx = self.w[prev].get(x, 0.0)
                if x not in self.w[prev] or wpx < self.thr[x]:
                    if w < self.thr[cur]:
                        alpha = min(1.0, 1.0 / self.q)
                    else:
                        alpha = 1.0 / self.q + (1.0 - 1.0 / self.q) * wpx / self.thr[x]
                else:
                    alpha = 1.0
            out[x] = w * alpha
        total = sum(out.values())
        return {x: v / total for x, v in out.items()}


def node2vec_probs(law, prev, cur):
    out = {}
    for x in law.nbrs[cur]:
        alpha = 1.0 if prev is None else (
            1.0 / law.p if x == prev else 1.0 if x in law.w[prev] else 1.0 / law.q)
        out[x] = law.w[cur][x] * alpha
    total = sum(out.values())
    return {x: v / total for x, v in out.items()}


def draw_walks(probs, n, n_walks, length, seed):
    """Walks on n nodes drawn exactly from ``probs(prev, cur)``."""
    rng = np.random.default_rng(seed)
    walks = np.zeros((n_walks, length), np.int64)
    walks[:, 0] = rng.integers(0, n, n_walks)
    for r in range(n_walks):
        for s in range(1, length):
            pr = probs(walks[r, s - 2] if s > 1 else None, walks[r, s - 1])
            xs = list(pr)
            walks[r, s] = xs[rng.choice(len(xs), p=np.array([pr[x] for x in xs]))]
    return torch.from_numpy(walks), torch.full((n_walks,), length)


@pytest.mark.parametrize("q,gamma", [(0.5, 0.0), (0.5, 0.5), (2.0, 0.0)])
def test_plus_expectations_equal_the_enumerated_law(q, gamma):
    indptr, indices, data = weighted_graph()
    g = walklaw.RefGraph(indptr, indices, data, "cpu")
    law = PlainLaw(indptr, indices, data, 0.5, q, gamma)
    assert np.allclose(g.thresholds(gamma).numpy(), law.thr, rtol=0, atol=1e-12)
    prev, cur = [], []
    for c in range(len(law.nbrs)):
        for t in law.nbrs[c]:
            prev.append(t)
            cur.append(c)
    prev = torch.tensor(prev + cur[:40])
    cur = torch.tensor(cur + cur[:40])
    first = torch.arange(cur.numel()) >= cur.numel() - 40
    nxt = cur.clone()  # the observed move plays no part in E[f]
    _, mean, var, _ = walklaw._stats(g, prev, cur, nxt, 0.5, q, first, 1 << 20,
                                     g.thresholds(gamma))
    counts = np.zeros(4)
    for i in range(cur.numel()):
        pv, c = (None, int(cur[i])) if first[i] else (int(prev[i]), int(cur[i]))
        probs = law.probs(pv, c)
        want = np.zeros(5)
        for x, pr in probs.items():
            kinds = (False,) * 4 if pv is None else law.kinds(pv, c, x)
            f = [kinds[0], kinds[1], kinds[2], law.w[c][x], kinds[3]]
            want += pr * np.array(f, float)
            if pv is not None:
                loose = kinds[1] and law.w[pv][x] < law.thr[x]
                counts += [loose, kinds[3], kinds[1] and not loose, kinds[2] and not kinds[3]]
        assert np.abs(mean[i].numpy() - want).max() < 1e-12, (i, mean[i], want)
    assert (var >= 0).all()
    # the graph has loose and tight common neighbours, noisy and plain out edges
    assert (counts > 0).all(), counts


def test_plus_law_z_small_on_its_own_walks_large_on_node2vec_s():
    indptr, indices, data = weighted_graph()
    g = walklaw.RefGraph(indptr, indices, data, "cpu")
    law = PlainLaw(indptr, indices, data, 0.5, 0.5, 0.0)
    walks, eff = draw_walks(law.probs, 60, 1500, 12, 1)
    z, nonedge = walklaw.law_z(g, walks, eff, 0.5, 0.5, 8000, 2, extend=True)
    assert nonedge == 0 and set(z) == set(walklaw.STAT_NAMES) | {walklaw.PLUS_STAT}
    assert max(abs(v) for v in z.values()) < 4.5, z
    walks, eff = draw_walks(lambda pv, c: node2vec_probs(law, pv, c), 60, 1500, 12, 1)
    z, _ = walklaw.law_z(g, walks, eff, 0.5, 0.5, 8000, 2, extend=True)
    assert max(abs(v) for v in z.values()) > 10.0, z


def _parent_stats(g, prev, cur, nxt, p, q, first, max_pairs):
    """``walklaw._stats`` as it was before node2vec+ came in, verbatim."""
    s = cur.numel()
    dev = g.device
    f_obs = torch.zeros((s, 4), dtype=torch.float64, device=dev)
    m1 = torch.zeros_like(f_obs)
    m2 = torch.zeros_like(f_obs)
    z = torch.zeros(s, dtype=torch.float64, device=dev)
    deg = g.deg[cur]
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
        common, _ = g.lookup(pv, x)
        is_common = common & ~is_ret & ~first[step]
        is_out = ~is_ret & ~is_common & ~first[step]
        alpha = torch.where(first[step], 1.0, torch.where(is_ret, 1.0 / p, torch.where(
            is_common, 1.0, 1.0 / q)))
        pw = w * alpha
        z.index_add_(0, step, pw)
        fs = torch.stack([is_ret.double(), is_common.double(), is_out.double(), w], 1)
        m1.index_add_(0, step, pw[:, None] * fs)
        m2.index_add_(0, step, pw[:, None] * fs * fs)
        lo = hi
    m1 = m1 / z[:, None]
    m2 = m2 / z[:, None]
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    found, w_obs = g.lookup(cur, nxt)
    ret_obs = (nxt == prev) & ~first
    common_obs, _ = g.lookup(prev, nxt)
    common_obs = common_obs & ~ret_obs & ~first
    out_obs = ~ret_obs & ~common_obs & ~first
    f_obs = torch.stack([ret_obs.double(), common_obs.double(), out_obs.double(), w_obs], 1)
    return f_obs, m1, var, found


def test_node2vec_law_is_bit_equal_to_the_parent_s(monkeypatch):
    indptr, indices, data = weighted_graph(n=80, p_edge=0.1, seed=9)
    g = walklaw.RefGraph(indptr, indices, data, "cpu")
    law = PlainLaw(indptr, indices, data, 0.5, 2.0, 0.0)
    walks, eff = draw_walks(lambda pv, c: node2vec_probs(law, pv, c), 80, 400, 10, 3)
    rows, pos = walklaw.sample_steps(walks, eff, 3000, 5)
    rows, pos = torch.from_numpy(rows), torch.from_numpy(pos)
    nxt, cur = walks[rows, pos], walks[rows, pos - 1]
    first = pos == 1
    prev = torch.where(first, cur, walks[rows, torch.clamp(pos - 2, min=0)])
    new = walklaw._stats(g, prev, cur, nxt, 0.5, 2.0, first, 997)
    old = _parent_stats(g, prev, cur, nxt, 0.5, 2.0, first, 997)
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    z_new, _ = walklaw.law_z(g, walks, eff, 0.5, 2.0, 3000, 5, max_pairs=997)
    monkeypatch.setattr(walklaw, "_stats", lambda *a: _parent_stats(*a[:8]))
    z_old, _ = walklaw.law_z(g, walks, eff, 0.5, 2.0, 3000, 5, max_pairs=997)
    assert list(z_new) == list(walklaw.STAT_NAMES) and z_new == z_old


def tiny(name, nodes):
    cell = cells.resolve(name)
    cell.config["graph"]["params"]["num_nodes"] = nodes
    return cell


@pytest.mark.parametrize("name,extend,gamma", [(CELL, True, 0.0), (CELL, True, 0.25),
                                               ("powerlaw1m.walks", False, 0)])
def test_set_up_builds_the_mode_the_configuration_states(name, extend, gamma):
    cell = tiny(name, 1500)
    if gamma:
        cell.config["gamma"] = gamma
    assert ("extend" in cell.config) == extend
    mode, _, _, _ = runner.set_up(cell, SEED, torch.device("cpu"), {})
    from pecanpy_tpu_torch import pecanpy

    plain = pecanpy.SparseOTF(p=cell.config["p"], q=cell.config["q"], device="cpu")
    assert (mode.p, mode.q) == (cell.config["p"], cell.config["q"])
    assert (mode.extend, mode.gamma) == ((True, gamma) if extend else (plain.extend, plain.gamma))
    assert mode.get_device_graph().gamma == gamma
    assert ("thr" in mode.get_device_graph().channels) == extend


def test_hub_round_ms_walks_plus_reads_window_over_rounds():
    from pecanpy_tpu_torch.utils import trace

    reader = cells.resolve(CELL).metric_reader("hub_round_ms.walks_plus")
    cell = tiny(CELL, 1500)
    result, diag = runner.run_cell(cell, SEED, 0.01, True, "cpu", 0.0)
    assert result["correct"]
    records = [r for r in trace.jobs() if not r.profiled][-diag["calls"]:]
    rounds = sum(r.counter("walk.hub_rounds") for r in records)
    assert rounds > 0
    ctx = dict(cell=cell, config=cell.config, traffic=cell.traffic, calls=diag["call_s"],
               window_s=diag["window_s"], profile=None)
    assert reader.read(ctx) == 1e3 * diag["window_s"] / rounds
    assert diag["cpu_numbers"]["hub_round_ms.walks_plus"]["value"] == reader.read(ctx)
    flat = tiny("uniform1m.walks", 1500)  # no hubs: no rounds
    _, diag = runner.run_cell(flat, SEED, 0.01, True, "cpu", 0.0)
    ctx = dict(cell=flat, config=flat.config, traffic=flat.traffic, calls=diag["call_s"],
               window_s=diag["window_s"], profile=None)
    assert reader.read(ctx) is None


@pytest.mark.parametrize("control", ["node2vec", "q1"])
def test_controls_fail_the_plus_law(control, monkeypatch):
    """The node2vec+ cell's controls: the same calls walked as node2vec
    (``extend`` off) at the same p and q, or at q = 1, judged by the
    configuration's node2vec+ law."""
    call = entries.WalksEntry.call

    def control_call(self, seed):
        if control == "node2vec":
            self.mode.extend = False
        else:
            self.mode.q = 1.0
        return call(self, seed)

    monkeypatch.setattr(entries.WalksEntry, "call", control_call)
    result, diag = runner.run_cell(tiny(CELL, 6000), SEED, 0.05, False, "cpu", 0.0)
    assert not result["correct"]
    assert diag["readings"]["law_z"] > cells.resolve(CELL).limits["law_z"], diag["readings"]


def test_fault_hub_walk_altered_where_produced(monkeypatch):
    from pecanpy_tpu_torch.models import engine

    original = engine.generate_walks_queued

    def altered(*args, **kwargs):
        walks, eff = original(*args, **kwargs)
        walks[0, 7] = (walks[0, 7] + 1) % 6000
        return walks, eff

    monkeypatch.setattr(engine, "generate_walks_queued", altered)
    result, diag = runner.run_cell(tiny(CELL, 6000), SEED, 0.05, False, "cpu", 0.0)
    assert not result["correct"] and diag["readings"]["walk_faults"] >= 1
