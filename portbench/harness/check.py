"""The numbers that decide ``correct``, each held to its limit.

Walks (every cell): every walk of the judged call is held to the graph
(``walk_faults``: a step that is no edge, a stop at a node with
neighbours, a length out of range), every node starts ``num_walks`` of
them (``start_faults``), and a seeded sample of their steps is held to
node2vec's law (``law_z``: the largest |z| of ``reference.walklaw``).

Training (embed cells): the set-up's warm-up ``embed(max_steps=3)`` runs
the window's own entry at the timed sizes; the plain reference follows
its first three chunk-steps from the seed and the same walks. Compared,
per table ("leaf"): the start (``start_gap``, exact), the first gradient
as the update rule received it, the table's change after one step
(``grad1_gap``), and the change after three (``change3_gap`` and
``change3_proj``); ``embed``'s returned table against the trainer's last
W_in (``final_gap``, exact); the window's last embeddings are finite
(``window_nonfinite``). A gap of norms is |norm(program) - norm(ref)|
over the larger of the reference leaf's norm and the median leaf's; a
leaf whose reference change is under a thousandth of the median leaf's
is left out (W_in does not move in the first step: W_out starts at 0).
``change3_proj`` is |<change(program), change(ref)> / |change(ref)|^2 - 1|,
which stochastic rounding's noise does not move (see PERF.md).

Only the numbers named in the cell's ``limits/<cell>.json`` decide
``correct``; the others are printed as readings.
"""
import math

import numpy as np
import torch

from reference import sgns_steps, walklaw


def walk_numbers(g: walklaw.RefGraph, walks, eff, num_walks, p, q, law_steps, seed):
    z, _ = walklaw.law_z(g, walks, eff, p, q, law_steps, seed)
    out = {
        "walk_faults": walklaw.check_walks(g, walks, eff),
        "start_faults": walklaw.check_starts(g, walks, num_walks),
        "law_z": max(abs(v) for v in z.values()),
    }
    out.update({f"z_{k}": v for k, v in z.items()})
    return out


def _norm(x):
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def _leaf_gaps(prog_deltas, ref_deltas):
    """Per leaf: (norm gap, projection gap) or None for a leaf left out."""
    ref_norms = [_norm(d) for d in ref_deltas]
    median = float(np.median(ref_norms))
    out = []
    for dp, dr, nr in zip(prog_deltas, ref_deltas, ref_norms):
        if nr < 1e-3 * median or nr == 0.0:
            out.append(None)
            continue
        base = max(nr, median)
        proj = float((dp.double() * dr.double()).sum()) / nr ** 2
        out.append((abs(_norm(dp) - nr) / base, abs(proj - 1.0)))
    return out


def training_numbers(prog_states, ref_states, prog_losses, ref_losses):
    """Gaps between a trajectory (the program's, or the control's) and the
    reference's over the first chunk-steps. States are [(w_in, w_out)]
    after 0..k steps, host tensors."""
    f32 = [tuple(x.to(torch.float32) for x in s) for s in prog_states]
    ref = [tuple(x.to(torch.float32) for x in s) for s in ref_states]
    out = {"start_gap": max(float((a - b).abs().max()) for a, b in zip(f32[0], ref[0]))}
    leaves = ("w_in", "w_out")
    g1 = _leaf_gaps([p - s for p, s in zip(f32[1], f32[0])],
                    [p - s for p, s in zip(ref[1], ref[0])])
    g3 = _leaf_gaps([p - s for p, s in zip(f32[-1], f32[0])],
                    [p - s for p, s in zip(ref[-1], ref[0])])
    for name, gaps in (("grad1", g1), ("change3", g3)):
        kept = [g for g in gaps if g is not None]
        out[f"{name}_gap"] = max(g[0] for g in kept)
        out[f"{name}_proj"] = max(g[1] for g in kept)
        for leaf, g in zip(leaves, gaps):
            if g is not None:
                out[f"{name}_gap.{leaf}"], out[f"{name}_proj.{leaf}"] = g
    out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses))
    return out


def embed_numbers(g, cfg, traffic, seed, warm, window_last, device, h=None):
    """Every number of an embed cell from the warm-up's capture."""
    h = h or sgns_steps.Hyper(dim=cfg["dim"], window=cfg["window_size"])
    chunks = warm["chunks"]
    walks = torch.cat([w for w, _ in chunks])
    eff = torch.cat([e for _, e in chunks])
    out = walk_numbers(g, walks, eff, cfg["num_walks"], cfg["p"], cfg["q"],
                       traffic["check"]["law_steps"], seed)
    del walks, eff
    stored = warm["states"][0][0].dtype
    ref_states, ref_losses, aux = sgns_steps.follow(
        chunks, g.n, warm["seed"], h, warm["steps"], stored, device)
    prog_losses = sgns_steps.state_losses(warm["states"], chunks, warm["seed"], h, aux, device)
    out.update(training_numbers(warm["states"], ref_states, prog_losses, ref_losses))
    returned = torch.from_numpy(np.asarray(warm["returned"]))
    out["final_gap"] = float((returned - warm["states"][-1][0].to(torch.float32)).abs().max())
    last = np.asarray(window_last) if window_last is not None else None
    ok = last is not None and last.shape == (g.n, cfg["dim"]) and bool(np.isfinite(last).all())
    out["window_nonfinite"] = 0 if ok else 1
    return out


def decide(numbers: dict, limits: dict):
    """(correct, {name: [value, limit]} for every limited number)."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and not math.isnan(value) and value <= limit
        correct = correct and good
        checks[name] = [value, limit]
    return correct, checks
