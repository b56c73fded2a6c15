"""Whole runs of the harness on the CPU at a tiny size: the check passes
sound runs and fails each fault a cell can have, and each control.

On the CPU the run measures nothing (no metric is written) and the port's
tables are float32; the streaming trainer is forced (it starts above 1e8
tokens) so that the tiny embed cells take the cells' path.
"""
import dataclasses

import pytest
import torch

from harness import cells, check, runner
from reference import sgns_steps, walklaw

SEED = 2**31 + 977  # past 32 signed bits, as a run's seed may be


@pytest.fixture
def streaming(monkeypatch):
    from pecanpy_tpu_torch.models import base

    monkeypatch.setattr(base.Base, "STREAMING_TOKEN_THRESHOLD", 0)


def tiny(name, nodes):
    cell = cells.resolve(name)
    cell.config["graph"]["params"]["num_nodes"] = nodes
    return cell


def run(cell, seed=SEED, trace=False):
    return runner.run_cell(cell, seed, 0.05, trace, "cpu", 0.0)


@pytest.mark.parametrize("name,nodes", [("uniform1m.walks", 3000), ("powerlaw1m.walks", 6000),
                                        ("uniform1m.embed", 2000), ("powerlaw1m.embed", 4000)])
def test_sound_run_is_correct_and_writes_no_metric(name, nodes, streaming):
    result, diag = run(tiny(name, nodes), trace=name.endswith("embed"))
    assert result["correct"], diag["readings"]
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cells.resolve(name).limits)


def test_fault_token_altered_where_produced(monkeypatch):
    from pecanpy_tpu_torch.models import engine

    original = engine.generate_walks

    def altered(*args, **kwargs):
        walks, eff = original(*args, **kwargs)
        walks[0, 7] = (walks[0, 7] + 1) % 3000
        return walks, eff

    monkeypatch.setattr(engine, "generate_walks", altered)
    result, diag = run(tiny("uniform1m.walks", 3000))
    assert not result["correct"] and diag["readings"]["walk_faults"] >= 1


def _broken_step(monkeypatch, how):
    from pecanpy_tpu_torch.models import sgns

    make = sgns.make_step_body

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(w_in, w_out, walks, eff_len, keep_prob, neg_table, lr, draws):
            if how == "unchanged":
                return w_in, w_out
            half = walks.shape[0] // 2
            slots = draws.neg_slots if draws.neg_slots.dim() == 1 else draws.neg_slots[:half]
            draws = dataclasses.replace(draws, u_sub=draws.u_sub[:half],
                                        eff_win=draws.eff_win[:half], neg_slots=slots)
            return step(w_in, w_out, walks[:half], eff_len[:half], keep_prob, neg_table, lr,
                        draws)

        return broken

    monkeypatch.setattr(sgns, "make_step_body", make_broken)


@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_fault_in_the_training_step(how, monkeypatch, streaming):
    _broken_step(monkeypatch, how)
    result, diag = run(tiny("uniform1m.embed", 2000))
    assert not result["correct"]
    limits = cells.resolve("uniform1m.embed").limits
    assert diag["readings"]["grad1_gap"] > limits["grad1_gap"]


def test_control_walks_break_the_in_out_guarantee(monkeypatch):
    """The walk cells' control: the program walking with q = 1 where the
    configuration states q = 2, judged by the configuration's law."""
    from harness import entries

    call = entries.WalksEntry.call

    def call_q1(self, seed):
        self.mode.q = 1.0
        return call(self, seed)

    monkeypatch.setattr(entries.WalksEntry, "call", call_q1)
    result, diag = run(tiny("uniform1m.walks", 3000))
    assert not result["correct"]
    assert diag["readings"]["law_z"] > cells.resolve("uniform1m.walks").limits["law_z"]


def test_control_embed_in_fp8_fails():
    """The embed cells' control: the reference in float8 e4m3 (per-tensor
    scale) in the program's place, the step below bf16 tables."""
    cell = tiny("uniform1m.embed", 2000)
    from harness import entries
    from pecanpy_tpu_torch import pecanpy
    import numpy as np
    import os
    import tempfile

    cfg = cell.config
    indptr, indices, data = cell.graph_generator().generate(5, **cfg["graph"]["params"])
    mode = pecanpy.SparseOTF(p=0.5, q=2, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.csr.npz")
        np.savez(path, indptr=indptr, indices=indices, data=data)
        mode.read_npz(path, weighted=True, implicit_ids=True)
    warm = entries.make(mode, cfg, cell.traffic).warm_up(41)
    h = sgns_steps.Hyper()
    ref, ref_l, _ = sgns_steps.follow(warm["chunks"], 2000, 41, h, 3, torch.float32, "cpu")
    low, low_l, _ = sgns_steps.follow(warm["chunks"], 2000, 41, h, 3, torch.float32, "cpu",
                                      store=sgns_steps.fp8_store)
    numbers = check.training_numbers(low, ref, low_l, ref_l)
    correct, _ = check.decide(numbers, {k: v for k, v in cell.limits.items()
                                        if k in numbers})
    assert not correct, numbers


def test_law_z_is_near_normal_on_exact_walks():
    """Walks drawn by a plain sampler of the law read |z| of a few units."""
    import numpy as np

    gen = cells.load_module(cells.BENCH_DIR / "graphs" / "uniform_random.py").generate
    indptr, indices, data = gen(3, 500, 8, 0)
    g = walklaw.RefGraph(indptr, indices, data, "cpu")
    rng = np.random.default_rng(0)
    walks = np.zeros((2000, 12), np.int64)
    walks[:, 0] = rng.integers(0, 500, 2000)
    for r in range(2000):
        for s in range(1, 12):
            cur = walks[r, s - 1]
            nb = indices[indptr[cur]:indptr[cur + 1]]
            w = data[indptr[cur]:indptr[cur + 1]].astype(np.float64)
            if s > 1:
                prev = walks[r, s - 2]
                pn = set(indices[indptr[prev]:indptr[prev + 1]].tolist())
                w = w * np.array([2.0 if x == prev else 1.0 if x in pn else 0.5 for x in nb])
            walks[r, s] = nb[rng.choice(nb.size, p=w / w.sum())]
    eff = torch.full((2000,), 12)
    z, nonedge = walklaw.law_z(g, torch.from_numpy(walks), eff, 0.5, 2.0, 8000, 1)
    assert nonedge == 0 and max(abs(v) for v in z.values()) < 4.5
