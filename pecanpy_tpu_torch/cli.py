"""Command-line interface of the PyTorch port.

The tasks of ``pecanpy_tpu/cli.py`` with the same flag names, plus
``--device``: the embedding task (read the graph, walk, train SGNS, write
the embeddings as ``.npz`` with keys IDs/data or as word2vec text), the
conversions ``tocsr`` / ``todense``, and ``walks`` (the raw walks, one
per line). Every walk mode runs, and the experimental
``Node2vecPlusPlus`` too. ``--trainer sequential`` walks on ``--device``
and trains on the host over ``--workers`` threads (the native gensim
loop). ``--profile``, ``--checkpoint-dir`` and ``--devices`` above 1
raise ``NotImplementedError`` naming ROADMAP.md.

Example::

    python -m pecanpy_tpu_torch.cli --input demo/karate.edg \\
        --output karate.emb --mode SparseOTF --device cuda
"""
import argparse
import warnings

import numpy as np

from pecanpy_tpu_torch import experimental, graph, pecanpy
from pecanpy_tpu_torch.wrappers import Timer

ROADMAP = "see ROADMAP.md, 'Modules to port'"


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
    parser.add_argument("--profile", metavar="DIR", default=None, help="Not ported yet.")
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
    parser.add_argument("--checkpoint-dir", default=None, help="Not ported yet.")
    parser.add_argument(
        "--checkpoint-every", type=int, default=100, help="Not ported yet."
    )
    parser.add_argument(
        "--max-steps",
        type=int,
        default=None,
        help="Stop training after this many chunk-steps (the lr schedule "
        "stays pinned to the full plan).",
    )
    parser.add_argument(
        "--devices", type=int, default=None, help="Only 1 is ported."
    )
    parser.add_argument(
        "--model-parallel", type=int, default=1, help="Only 1 is ported."
    )
    parser.add_argument(
        "--partition",
        type=str,
        default="auto",
        choices=("auto", "replicated", "edge"),
        help="Multi-device graph layout; not ported yet.",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Torch device to run on: 'cuda' (default) or 'cpu'.",
    )
    return parser.parse_args(argv)


def _reject_unported(args):
    if args.profile:
        raise NotImplementedError(f"--profile is not ported yet ({ROADMAP})")


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


def export_walks(args, g):
    """Write the walks as node-ID lines, cut at their effective lengths,
    one device chunk at a time: the corpus is never held as host lists."""
    ids = g.nodes
    with open(args.output, "w", encoding="utf-8") as f:
        for walks, eff in g._walk_chunks(args.num_walks, args.walk_length):
            for row, n in zip(walks.cpu().numpy(), eff.cpu().numpy()):
                f.write(" ".join(ids[node] for node in row[:n]))
                f.write("\n")


def main(argv=None):
    """End-to-end pipeline: read -> preprocess -> walk + embed -> save
    (or convert, or export the walks)."""
    args = parse_args(argv)
    _reject_unported(args)
    g = read_graph(args)
    if g is None:  # conversion task
        return
    preprocess(g)
    if args.task == "walks":
        Timer("generate walks", args.verbose)(export_walks)(args, g)
        return
    if args.trainer == "sequential":
        if args.devices is not None and args.devices > 1:
            raise ValueError(
                "--trainer sequential runs on the host; it cannot be "
                "combined with --devices"
            )
        embeddings = Timer("walks + train embeddings", args.verbose)(g.embed)(
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
    embeddings = Timer("walks + train embeddings", args.verbose)(g.embed)(
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
