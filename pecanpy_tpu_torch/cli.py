"""Command-line interface of the PyTorch port.

The tasks of ``pecanpy_tpu/cli.py`` with the same flag names, plus
``--device``: the embedding task (read the graph, walk, train SGNS, write
the embeddings as ``.npz`` with keys IDs/data or as word2vec text), the
conversions ``tocsr`` / ``todense``, and ``walks`` (the raw walks, one
per line). Every walk mode runs, and the experimental
``Node2vecPlusPlus`` too. ``--trainer sequential`` walks on ``--device``
and trains on the host over ``--workers`` threads (the native gensim
loop). ``--checkpoint-dir`` snapshots training and resumes from the latest
snapshot; ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of
the pipeline into DIR. ``--devices N`` above 1 walks and trains on N
ranks, one process each (``parallel/``): the walkers split over the data
ranks, the tables along the dimension over ``--model-parallel`` ranks,
and the graph replicated on every rank or row-sharded over the data ranks
(``--partition``); ranks that share a card need
``PECANPY_TPU_DIST_BACKEND=gloo``.

The embedding task runs as the JAX CLI's timed stages: ``load Graph``,
``pre-compute transition probabilities``, then ``generate walks``
(``simulate_walks``) and ``train embeddings`` (``learn_embeddings``, which
also writes the output). Streaming runs (``--streaming``, or above ~1e8
tokens), ``--trainer sequential`` and ``--devices`` above 1 walk and
train inside one ``embed`` call, which prints its own stage lines.

Example (installed as the ``pecanpy-tpu-torch`` console script)::

    python -m pecanpy_tpu_torch.cli --input demo/karate.edg \\
        --output karate.emb --mode SparseOTF --device cuda
"""
import argparse
import contextlib
import os
import time
import warnings

import numpy as np

from pecanpy_tpu_torch import experimental, graph, pecanpy
from pecanpy_tpu_torch.utils import trace
from pecanpy_tpu_torch.wrappers import Timer


def parse_args(argv=None):
    """Parse node2vec arguments (the JAX package's flag names)."""
    parser = argparse.ArgumentParser(
        description="Run the PyTorch/CUDA port of pecanpy-tpu "
        "(node2vec(+) walks and SGNS on one GPU)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "--input", required=True, help="Path to the input graph (.edg edgelist or .npz CSR/dense)."
    )
    parser.add_argument(
        "--output",
        required=True,
        help="Where to write the embeddings: a .npz archive when the path "
        "ends in .npz, word2vec text format otherwise.",
    )
    parser.add_argument(
        "--task",
        default="pecanpy",
        choices=["pecanpy", "tocsr", "todense", "walks"],
        help="Pipeline to run: full embedding, graph format conversion, "
        "or `walks` to write the raw random walks (one space-separated "
        "node-ID walk per line).",
    )
    parser.add_argument(
        "--mode",
        default="SparseOTF",
        choices=[
            "DenseOTF",
            "FirstOrderUnweighted",
            "Node2vecPlusPlus",
            "PreComp",
            "PreCompFirstOrder",
            "SparseOTF",
        ],
        help="Walk engine variant (Node2vecPlusPlus is experimental).",
    )
    parser.add_argument(
        "--dimensions", type=int, default=128, help="Embedding dimensionality."
    )
    parser.add_argument(
        "--walk-length", type=int, default=80, help="Steps taken by each walk."
    )
    parser.add_argument(
        "--num-walks", type=int, default=10, help="Walks started from every node."
    )
    parser.add_argument(
        "--window-size", type=int, default=10, help="Skip-gram context window radius."
    )
    parser.add_argument(
        "--epochs", type=int, default=1, help="Number of SGNS training epochs."
    )
    parser.add_argument(
        "--workers",
        type=int,
        default=0,
        help="Host threads of --trainer sequential (hogwild); 0 uses "
        "every host CPU.",
    )
    parser.add_argument("--p", type=float, default=1, help="node2vec return parameter (bias 1/p toward the previous node).")
    parser.add_argument("--q", type=float, default=1, help="node2vec in-out parameter (bias 1/q on outward edges).")
    parser.add_argument(
        "--weighted", action="store_true", help="Treat the third edgelist column as edge weights."
    )
    parser.add_argument(
        "--directed", action="store_true", help="Keep edges one-directional (default inserts both directions)."
    )
    parser.add_argument(
        "--verbose", action="store_true", help="Print stage timings and progress."
    )
    parser.add_argument(
        "--extend", action="store_true", help="Enable the node2vec+ extended transition weights."
    )
    parser.add_argument(
        "--gamma", type=float, default=0, help="node2vec+ noise-threshold std multiplier."
    )
    parser.add_argument(
        "--random_state",
        type=int,
        default=None,
        help="Seed for the walk and training generators and the start-node shuffle.",
    )
    parser.add_argument(
        "--delimiter", type=str, default="\t", help="Column separator of the edgelist file."
    )
    parser.add_argument(
        "--implicit_ids",
        action="store_true",
        help="Number nodes 0..N-1 instead of reading an IDs array.",
    )
    parser.add_argument(
        "--degree-cap",
        type=int,
        default=None,
        help="Max degree of the fused rows (default 128; 0 disables "
        "capping). Nodes above it are hubs, walked by exact rejection "
        "sampling from flat alias and hash tables.",
    )
    parser.add_argument(
        "--walker-batch",
        type=int,
        default=None,
        help="Walkers advanced together (default 131072; 32768 walker "
        "lanes on graphs with hubs).",
    )
    parser.add_argument(
        "--table-dtype",
        choices=["auto", "float32", "bfloat16"],
        default="auto",
        help="Embedding-table dtype. 'auto' picks bfloat16 (stochastic-"
        "rounding updates) on a GPU above 16M table elements, float32 "
        "otherwise.",
    )
    parser.add_argument(
        "--streaming",
        choices=["auto", "on", "off"],
        default="auto",
        help="Stream walks into training. auto: on above ~1e8 tokens.",
    )
    parser.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="Capture a torch.profiler trace of the pipeline (host "
        "activity, the port's pecanpy.* spans, and the CUDA kernels on a "
        "GPU) into DIR as a Chrome trace JSON (view in chrome://tracing or "
        "Perfetto).",
    )
    parser.add_argument(
        "--trainer",
        choices=["tpu", "sequential"],
        default="tpu",
        help="SGNS implementation: 'tpu' is the batched device trainer "
        "(here on --device); 'sequential' walks on --device, then trains "
        "on host threads (native C++, hogwild over --workers threads) "
        "with gensim's exact sequential loop: the quality reference, "
        "at host CPU speed, for small graphs.",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Snapshot the SGNS training state into this directory "
        "every --checkpoint-every chunk-steps, and resume from the "
        "latest snapshot when one exists (bit-identical to an "
        "uninterrupted run).",
    )
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=100,
        help="Checkpoint period in training chunk-steps.",
    )
    parser.add_argument(
        "--max-steps",
        type=int,
        default=None,
        help="Stop training after this many chunk-steps (combine with "
        "--checkpoint-dir to split a long run across invocations; the "
        "lr schedule stays pinned to the full plan).",
    )
    parser.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Run the fused multi-device pipeline over this many ranks, one "
        "process each (walkers data-parallel, tables tensor-parallel); "
        "ranks that share a card need PECANPY_TPU_DIST_BACKEND=gloo.",
    )
    parser.add_argument(
        "--model-parallel",
        type=int,
        default=1,
        help="Tensor-parallel shards for the embedding tables "
        "(must divide --devices).",
    )
    parser.add_argument(
        "--partition",
        type=str,
        default="auto",
        choices=("auto", "replicated", "edge"),
        help="Graph layout over the ranks: 'replicated' (full table per "
        "rank), 'edge' (table row-sharded over the data ranks with "
        "collective row fetches: graphs bigger than one card's memory), "
        "or 'auto' (edge once the tables exceed the per-rank budget, "
        "PECANPY_TPU_REPLICATED_BUDGET_MB, default half the card's "
        "memory). Both layouts train bit-identical embeddings.",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Torch device to run on: 'cuda' (default) or 'cpu'.",
    )
    return parser.parse_args(argv)


def check_mode(g, args):
    """Validate mode constraints and recommend better modes (the JAX CLI's
    decision table, reference ``cli.py:179-254``): FirstOrderUnweighted
    requires unweighted p = q = 1, PreCompFirstOrder p = q = 1; density
    thresholds steer PreComp / SparseOTF / DenseOTF."""
    mode, weighted, p, q = args.mode, args.weighted, args.p, args.q

    if mode == "FirstOrderUnweighted":
        if not p == q == 1 or weighted:
            raise ValueError(
                f"FirstOrderUnweighted only works when weighted = False and "
                f"p = q = 1, got {weighted=}, {p=}, {q=}",
            )
        return
    if p == q == 1 and not weighted:
        warnings.warn(
            f"unweighted graph with p = q = 1: FirstOrderUnweighted would "
            f"be much faster and lighter than the selected {mode}",
            stacklevel=2,
        )
        return

    if mode == "PreCompFirstOrder":
        if not p == q == 1:
            raise ValueError(
                f"PreCompFirstOrder only works when p = q = 1, got {p=}, {q=}",
            )
        return
    if p == 1 == q:
        warnings.warn(
            f"p = q = 1 makes the walk first-order: PreCompFirstOrder would "
            f"be much faster than the selected {mode} at little memory cost",
            stacklevel=2,
        )
        return

    size, dens = g.num_nodes, g.density
    if dens >= 0.2 and mode != "DenseOTF":
        warnings.warn(
            f"density {dens:.3f} >= 0.2: DenseOTF usually beats the "
            f"selected {mode} on graphs this dense",
            stacklevel=2,
        )
    if dens < 0.001 and size < 10000 and mode != "PreComp":
        warnings.warn(
            f"density {dens:.2e} < 0.001 and {size} nodes < 10000: PreComp "
            f"usually beats the selected {mode} on small sparse graphs",
            stacklevel=2,
        )
    if 0.001 <= dens < 0.2 and mode != "SparseOTF":
        warnings.warn(
            f"density {dens:.3f} sits in SparseOTF's sweet spot "
            f"(0.001-0.2); consider it over the selected {mode}",
            stacklevel=2,
        )
    if dens < 0.001 and size >= 10000 and mode != "SparseOTF":
        warnings.warn(
            f"density {dens:.3f} < 0.001 with {size} nodes >= 10000: "
            f"SparseOTF usually beats the selected {mode} at this scale",
            stacklevel=2,
        )


@Timer("load Graph")
def read_graph(args):
    """Load the input network into the selected mode; the conversion
    tasks save it and return None."""
    if args.directed and args.extend:
        raise NotImplementedError(
            "Node2vec+ not implemented for directed graph yet."
        )
    if args.extend and not args.weighted:
        print("NOTE: node2vec+ is equivalent to node2vec for unweighted graphs.")

    if args.task in ("tocsr", "todense"):
        g = graph.SparseGraph() if args.task == "tocsr" else graph.DenseGraph()
        g.read_edg(args.input, args.weighted, args.directed, args.delimiter)
        g.save(args.output)
        return None

    if args.mode == "Node2vecPlusPlus":
        mode_cls = experimental.Node2vecPlusPlus
    else:
        mode_cls = getattr(pecanpy, args.mode)
    extra = {}
    if args.degree_cap is not None:
        extra["degree_cap"] = args.degree_cap if args.degree_cap > 0 else None
    if args.walker_batch is not None:
        extra["walker_batch"] = args.walker_batch
    g = mode_cls(
        p=args.p,
        q=args.q,
        workers=args.workers,
        verbose=args.verbose,
        extend=args.extend,
        gamma=args.gamma,
        random_state=args.random_state,
        device=args.device,
        **extra,
    )
    if args.input.endswith(".npz"):
        g.read_npz(args.input, args.weighted, implicit_ids=args.implicit_ids)
    else:
        g.read_edg(args.input, args.weighted, args.directed, args.delimiter)
    check_mode(g, args)
    return g


def save_embeddings(path: str, node_ids, embeddings: np.ndarray):
    """Write embeddings as .npz (keys IDs/data) or word2vec text format:
    a ``"<vocab> <dim>"`` header, then one ``<id> <v1> ... <vd>`` row per
    node."""
    if path.endswith(".npz"):
        np.savez(path, IDs=node_ids, data=embeddings)
        return
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(node_ids)} {embeddings.shape[1]}\n")
        for node_id, row in zip(node_ids, embeddings):
            vec = " ".join(repr(float(v)) for v in row)
            f.write(f"{node_id} {vec}\n")


@Timer("pre-compute transition probabilities")
def preprocess(g):
    """Transition-probability preprocessing stage (timed)."""
    g.preprocess_transition_probs()


@Timer("generate walks")
def simulate_walks(args, g):
    """Walk generation stage (timed); keeps the walks on the device."""
    return g.simulate_walks_device(args.num_walks, args.walk_length)


@Timer("train embeddings")
def learn_embeddings(args, g, walks, eff_len):
    """SGNS training stage (timed) and output writing; the trainer config
    and its advisories are ``embed``'s (``Base._sgns_config``)."""
    total_tokens = g.num_nodes * args.num_walks * (args.walk_length + 1)
    config = g._sgns_config(
        args.dimensions, args.window_size, args.epochs, args.table_dtype, None,
        total_tokens,
    )
    embeddings = g._train_device(
        walks, eff_len, config, args.verbose, args.checkpoint_dir,
        args.checkpoint_every, args.max_steps,
    )
    save_embeddings(args.output, g.nodes, embeddings)


def export_walks(args, g):
    """Write the walks as node-ID lines, cut at their effective lengths,
    one device chunk at a time: the corpus is never held as host lists."""
    ids = g.nodes
    with open(args.output, "w", encoding="utf-8") as f:
        for walks, eff in g._walk_chunks(args.num_walks, args.walk_length):
            with trace.sync("pecanpy.walk.read"):
                walks = walks.cpu().numpy()
            with trace.sync("pecanpy.walk.read"):
                eff = eff.cpu().numpy()
            for row, n in zip(walks, eff):
                f.write(" ".join(ids[node] for node in row[:n]))
                f.write("\n")


@contextlib.contextmanager
def profiled(directory: str, device: str):
    """Trace the enclosed work with ``torch.profiler`` (host activity,
    plus the CUDA activity on a GPU), with the port's spans enabled
    (``utils/trace.py``: each a ``pecanpy.*`` range beside the kernels),
    and write it into ``directory`` as a Chrome trace JSON."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    trace.enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        trace.disable()
    prof.export_chrome_trace(
        os.path.join(directory, f"pecanpy_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    )


def main(argv=None):
    """End-to-end pipeline: read -> preprocess -> walk + embed -> save
    (or convert, or export the walks), under the profiler with
    ``--profile``."""
    args = parse_args(argv)
    if args.profile:
        with profiled(args.profile, args.device):
            return _run(args)
    return _run(args)


def _run(args):
    g = read_graph(args)
    if g is None:  # conversion task
        return
    preprocess(g)
    if args.task == "walks":
        if args.devices is not None and args.devices > 1:
            warnings.warn(
                "--task walks runs single-device; --devices is ignored "
                "(use the default embedding task for multi-device runs)",
                stacklevel=2,
            )
        Timer("generate walks", args.verbose)(export_walks)(args, g)
        return
    if args.trainer == "sequential":
        if args.devices is not None and args.devices > 1:
            raise ValueError(
                "--trainer sequential runs on the host; it cannot be "
                "combined with --devices"
            )
        embeddings = g.embed(
            dim=args.dimensions,
            num_walks=args.num_walks,
            walk_length=args.walk_length,
            window_size=args.window_size,
            epochs=args.epochs,
            verbose=args.verbose,
            trainer="sequential",
            checkpoint_dir=args.checkpoint_dir,  # embed() rejects it
        )
        save_embeddings(args.output, g.nodes, embeddings)
        return
    total_tokens = g.num_nodes * args.num_walks * (args.walk_length + 1)
    streaming = args.streaming == "on" or (
        args.streaming == "auto"
        and total_tokens > type(g).STREAMING_TOKEN_THRESHOLD
    )
    if not streaming and (args.devices is None or args.devices <= 1):
        walks, eff_len = simulate_walks(args, g)
        learn_embeddings(args, g, walks, eff_len)
        return
    embeddings = g.embed(
        dim=args.dimensions,
        num_walks=args.num_walks,
        walk_length=args.walk_length,
        window_size=args.window_size,
        epochs=args.epochs,
        verbose=args.verbose,
        streaming=streaming,
        table_dtype=args.table_dtype,
        n_devices=args.devices,
        model_parallel=args.model_parallel,
        partition=args.partition,
        trainer=args.trainer,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        max_steps=args.max_steps,
    )
    save_embeddings(args.output, g.nodes, embeddings)


if __name__ == "__main__":
    main()
