"""Readings that set a cell's limits: the program's numbers and its
control's, over many seeds, at the cell's own size, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... [--control-seeds 3]

For each seed it makes the run's set-up (graph, layout, warm-up) and
prints one JSON line of readings:

* walk cells: one call of the entry judged as a run judges it (the
  program's readings), then the control: the same call with the program
  walking at q = 1 where the configuration states q = 2, judged by the
  configuration's law;
* embed cells: the warm-up's first chunk-steps judged as a run judges
  them (the program's readings), then, on the first ``--control-seeds``
  seeds, the control: the plain reference in the program's place with
  its tables stored in float8 e4m3 (per-tensor scale), the precision
  below the configuration's bf16 tables, against the float32 reference.

The benchmark's runs never run this. Needs the card, as a run does.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch

    from harness import cells, check, runner
    from reference import sgns_steps, walklaw

    cell = cells.resolve(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cfg, traffic = cell.config, cell.traffic
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        diag = {}
        mode, entry, warm, graph = runner.set_up(cell, seed, device, diag)
        out = {"cell": cell.name, "seed": seed}
        check_seed = runner.derived_seed(seed, 4)
        if traffic["entry"] == "walks":
            walks, eff = entry.call(runner.derived_seed(seed, 2, 0))
            do_control = k < args.control_seeds
            if do_control:
                mode.q = 1.0
                c_walks, c_eff = entry.call(runner.derived_seed(seed, 2, 0))
                mode.q = cfg["q"]
            entry.release()
            mode._device_graph = None
            torch.cuda.empty_cache() if device.type == "cuda" else None
            g = walklaw.RefGraph(*graph, device)
            out["program"] = check.walk_numbers(g, walks, eff, cfg["num_walks"], cfg["p"],
                                                cfg["q"], traffic["check"]["law_steps"],
                                                check_seed)
            del walks, eff
            if do_control:
                out["control"] = check.walk_numbers(
                    g, c_walks, c_eff, cfg["num_walks"], cfg["p"], cfg["q"],
                    traffic["check"]["law_steps"], check_seed)
        else:
            mode._device_graph = None
            torch.cuda.empty_cache() if device.type == "cuda" else None
            g = walklaw.RefGraph(*graph, device)
            out["program"] = check.embed_numbers(g, cfg, traffic, check_seed, warm, None, device)
            if k < args.control_seeds:
                h = sgns_steps.Hyper(dim=cfg["dim"], window=cfg["window_size"])
                stored = warm["states"][0][0].dtype
                ref, ref_l, _ = sgns_steps.follow(warm["chunks"], g.n, warm["seed"], h,
                                                  warm["steps"], stored, device)
                low, low_l, _ = sgns_steps.follow(warm["chunks"], g.n, warm["seed"], h,
                                                  warm["steps"], stored, device,
                                                  store=sgns_steps.fp8_store)
                out["control"] = check.training_numbers(low, ref, low_l, ref_l)
        out["seconds"] = time.perf_counter() - t0
        out["setup"] = diag
        print(json.dumps(out), flush=True)
        del mode, entry, warm, graph, g
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    sys.exit(main(sys.argv[1:]))
