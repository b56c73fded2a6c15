"""Walk-mode base class: device-graph management, walk driver, embedding.

Counterpart of ``pecanpy_tpu/models/base.py``: the constructor parameters
``p, q, workers, verbose, extend, gamma, random_state``, the
``simulate_walks`` / ``embed`` entry points and the one-shot
``preprocess_transition_probs`` hook, plus an explicit ``device``. Walks
run batched on the device (``models/engine.py``); embeddings train with
the batched SGNS trainer (``models/sgns.py``) on this mode's device, or
with ``trainer="sequential"`` on the host with the native gensim loop.

Reproducibility: a fixed ``random_state`` fixes the start-node shuffle
(the same numpy shuffle as the JAX package, so walk *sets* line up) and
the torch generators of every walk chunk and training step. The port and
the JAX package agree in distribution, not sample for sample.
"""
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from pecanpy_tpu_torch.graph import BaseGraph
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops.layout import DEFAULT_DEGREE_CAP, DeviceCSR
from pecanpy_tpu_torch.typing import Embeddings
from pecanpy_tpu_torch.wrappers import Timer

DEFAULT_WALKER_BATCH = 131072
# hub graphs walk with fewer lanes: the hub walkers' straggler tail (the
# max over lanes of summed geometric retries) grows with the batch
# (``pecanpy_tpu/models/base.py``)
DEFAULT_HUB_WALKER_BATCH = 32768

ROADMAP_SLICES = "see ROADMAP.md, 'Modules to port'"


def resolve_device(device) -> torch.device:
    """The device a mode runs on; never falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch finds no CUDA device; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


class Base(BaseGraph):
    """Skeleton for the walk modes.

    Args:
        p: return parameter (bias 1/p on the edge back to the previous node).
        q: in-out parameter (bias 1/q on edges leaving prev's neighborhood).
        workers: host threads of ``embed(trainer="sequential")``
            (hogwild); 0 or less means every host CPU.
        verbose: print stage timings / progress.
        extend: use the node2vec+ extended transition weights.
        gamma: node2vec+ noise-threshold std multiplier.
        random_state: seed for start-node shuffling and the walk and
            training generators.
        walker_batch: walkers advanced together; None resolves per graph:
            131072 without hubs, 32768 walker lanes with hubs.
        degree_cap: nodes above this degree are hubs, served by the flat
            hub tables and the rejection walkers (``ops/hubs.py``); None
            pads fused rows to the true max degree.
        device: "cuda" (default) or "cpu"; "cuda" without a CUDA device
            raises.
    """

    def __init__(
        self,
        p: float = 1,
        q: float = 1,
        workers: int = 1,
        verbose: bool = False,
        extend: bool = False,
        gamma: float = 0,
        random_state: Optional[int] = None,
        walker_batch: Optional[int] = None,
        degree_cap: Optional[int] = DEFAULT_DEGREE_CAP,
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.degree_cap = degree_cap
        self.p = p
        self.q = q
        self.workers = workers
        self.verbose = verbose
        self.extend = extend
        self.gamma = gamma
        self.random_state = random_state
        self._resolved_seed: Optional[int] = None
        self.walker_batch = walker_batch
        self._device_graph: Optional[DeviceCSR] = None
        self._preprocessed: bool = False

    # -- device graph -------------------------------------------------------

    def _build_device_graph(self) -> DeviceCSR:
        raise NotImplementedError

    def get_device_graph(self) -> DeviceCSR:
        """Padded device layout of this graph (built once, cached)."""
        if self._device_graph is None:
            self._device_graph = self._build_device_graph()
        return self._device_graph

    # -- mode plug points ----------------------------------------------------

    def make_step_fns(self):
        """Return (first_fn, step_fn), each taking (dg, u, ...)."""
        raise NotImplementedError

    def _draw_width(self) -> int:
        """Uniforms each walk step draws (the step functions' ``u`` is
        [B, width]); 1 unless a mode needs more."""
        return 1

    def preprocess_transition_probs(self):
        """Build device-resident state ahead of walking (the device graph)."""
        self.get_device_graph()

    def _preprocess_transition_probs(self):
        if not self._preprocessed:
            self.preprocess_transition_probs()
            self._preprocessed = True

    # -- walk driver ---------------------------------------------------------

    def _resolved_walker_batch(self) -> int:
        if self.walker_batch is not None:
            return self.walker_batch
        if self.get_device_graph().has_hubs:
            return DEFAULT_HUB_WALKER_BATCH
        return DEFAULT_WALKER_BATCH

    def _walk_queue_factor(self) -> int:
        """Walks per chunk, in units of walker lanes (the hub modes
        override it: their queued engine amortizes stragglers per chunk)."""
        return 1

    def _make_walk_runner(self, walk_length: int):
        """The (dg, start, chunk index) -> (walks, eff) walk callable.

        Default: the scan engine over this mode's step functions, fed by
        ``engine.walk_uniforms(seed, chunk index, width)``. The OTF modes
        route hub graphs to the hub engines instead.
        """
        first_fn, step_fn = self.make_step_fns()
        width = self._draw_width()

        def run(dg, start, chunk_idx):
            u = engine.walk_uniforms(
                self._seed(), chunk_idx, walk_length, start.shape[0], self.device,
                width,
            )
            return engine.generate_walks(
                dg,
                lambda uu, cur, rows: first_fn(dg, uu, cur, rows),
                lambda uu, cur, prev, cr, pr: step_fn(dg, uu, cur, prev, cr, pr),
                start,
                u,
                walk_length,
            )

        return run

    def _seed(self) -> int:
        """Concrete seed for this instance, resolved exactly once.

        With ``random_state=None`` one entropy draw is pinned on first use,
        so every later pass (the streaming vocab scan, each training
        epoch) sees the identical start-node shuffle and walk stream.
        """
        if self._resolved_seed is None:
            if self.random_state is not None:
                self._resolved_seed = int(self.random_state)
            else:
                self._resolved_seed = int(
                    np.random.default_rng().integers(0, 2**31 - 1)
                )
        return self._resolved_seed

    def _start_nodes(self, num_walks: int) -> np.ndarray:
        """Every node repeated num_walks times, shuffled under the seed
        (the same numpy shuffle as ``pecanpy_tpu/models/base.py``)."""
        nodes = np.arange(self.num_nodes, dtype=np.int32)
        starts = np.concatenate([nodes] * num_walks)
        np.random.seed(self._seed())
        np.random.shuffle(starts)
        return starts

    def _walk_chunks(self, num_walks: int, walk_length: int):
        """Yield (walks, eff_len) device chunks, deterministically.

        Chunk i draws from a generator seeded by (seed, i), so every call
        reproduces the identical chunk stream: the contract the streaming
        trainer's passes rely on.
        """
        self._preprocess_transition_probs()
        dg = self.get_device_graph()
        run = self._make_walk_runner(walk_length)

        starts = self._start_nodes(num_walks)
        total = starts.size
        chunk = min(
            self._resolved_walker_batch() * self._walk_queue_factor(), total
        )
        n_chunks = -(-total // chunk)
        t0 = time.perf_counter()
        for i, lo in enumerate(range(0, total, chunk)):
            part = starts[lo : lo + chunk]
            walks, eff = run(dg, torch.from_numpy(part).to(self.device), i)
            if self.verbose and n_chunks > 1:
                done = min(lo + chunk, total)
                rate = done * walk_length / max(
                    time.perf_counter() - t0, 1e-9
                )
                print(
                    f"walks: chunk {i + 1}/{n_chunks} "
                    f"({done}/{total} walkers, {rate:.2e} steps/s)",
                    flush=True,
                )
            yield walks, eff

    def simulate_walks_device(
        self, num_walks: int, walk_length: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generate all walks on the device.

        Returns:
            walks: [num_walks * N, walk_length + 1] int32 node indices.
            eff_len: [num_walks * N] int32 effective walk lengths.
        """
        parts = list(self._walk_chunks(num_walks, walk_length))
        if len(parts) == 1:
            return parts[0]
        return (
            torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
        )

    def simulate_walks(self, num_walks: int, walk_length: int) -> List[List[str]]:
        """Generate walks as lists of node-ID strings (reference API)."""
        walks, eff_len = self.simulate_walks_device(num_walks, walk_length)
        walks = walks.cpu().numpy()
        eff_len = eff_len.cpu().numpy()
        ids = self.nodes
        return [
            [ids[node] for node in row[:n]] for row, n in zip(walks, eff_len)
        ]

    # -- embedding -----------------------------------------------------------

    # tokens above which embed() streams walks instead of storing them
    STREAMING_TOKEN_THRESHOLD = 100_000_000

    def embed(
        self,
        dim: int = 128,
        num_walks: int = 10,
        walk_length: int = 80,
        window_size: int = 10,
        epochs: int = 1,
        verbose: bool = False,
        streaming: Optional[bool] = None,
        table_dtype: str = "auto",
        n_devices: Optional[int] = None,
        model_parallel: int = 1,
        partition: str = "auto",
        batch_walks: Optional[int] = None,
        trainer: str = "tpu",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        max_steps: Optional[int] = None,
    ) -> Embeddings:
        """Walks + batched SGNS, returning graph-aligned embeddings.

        Same signature and defaults as ``pecanpy_tpu``'s ``embed`` (the
        trainer name ``"tpu"`` selects the batched trainer, here on this
        mode's device). Row i of the result embeds node i.

        ``streaming=None`` streams walks into training (two passes over a
        walk cache) once the corpus exceeds ~1e8 tokens. ``max_steps``
        stops after that many chunk-steps; the lr schedule stays pinned
        to the full plan.

        ``trainer="sequential"`` walks on this mode's device, then trains
        on the host with gensim's exact sequential loop (native C++,
        hogwild over ``self.workers`` threads): the quality reference, at
        host CPU speed, for small graphs. It takes neither
        ``n_devices > 1``, ``streaming=True`` nor ``checkpoint_dir``
        (``ValueError``).

        Not ported yet, and raising ``NotImplementedError``:
        ``n_devices > 1`` and ``checkpoint_dir``.
        """
        from pecanpy_tpu_torch.models import sgns

        if trainer not in ("tpu", "sequential"):
            raise ValueError(
                f"unknown trainer {trainer!r}; use 'tpu' or 'sequential'"
            )
        if partition not in ("auto", "replicated", "edge"):
            raise ValueError(
                f"unknown partition {partition!r}; use 'auto', "
                "'replicated', or 'edge'"
            )
        sequential = trainer == "sequential"
        if sequential:
            if n_devices is not None and n_devices > 1:
                raise ValueError(
                    "trainer='sequential' runs on the host; it cannot be "
                    "combined with n_devices > 1"
                )
            if streaming:
                raise ValueError(
                    "trainer='sequential' trains on materialized host "
                    "walks; it cannot honor streaming=True (drop one of "
                    "the two)"
                )
            if checkpoint_dir is not None:
                raise ValueError(
                    "trainer='sequential' (the host gensim loop) has no "
                    "checkpoint/resume support; use the batched trainer"
                )
        if n_devices is not None and n_devices > 1:
            raise NotImplementedError(
                f"n_devices > 1: multi-device training is not ported yet "
                f"({ROADMAP_SLICES}, slice D)"
            )
        if checkpoint_dir is not None:
            raise NotImplementedError(
                f"checkpoint_dir: checkpoint and resume are not ported yet "
                f"({ROADMAP_SLICES})"
            )

        config = sgns.SGNSConfig(
            dim=dim,
            window=window_size,
            epochs=epochs,
            seed=self.random_state,
            table_dtype=table_dtype,
            batch_walks=batch_walks,
        )
        total_tokens = self.num_nodes * num_walks * (walk_length + 1)
        if sequential and total_tokens > 5e7:
            warnings.warn(
                f"trainer='sequential' trains ~{total_tokens:.1e} tokens on "
                "host CPU threads: expect minutes to hours; the batched "
                "trainer is about two orders of magnitude faster at this "
                "scale",
                stacklevel=2,
            )
        if not sequential and epochs == 1 and total_tokens <= 5e7:
            # advisory only, as in the JAX package: there the batched
            # trainer's per-epoch quality trailed the sequential reference
            # at small corpus scale and epochs=2 closed the gap
            warnings.warn(
                f"epochs=1 on a small corpus (~{total_tokens:.1e} tokens) "
                "leaves quality on the table: with the JAX reference "
                "trainer, epochs=2 matches the sequential reference "
                "(micro-F1 0.542 vs 0.541 at BlogCatalog scale)",
                stacklevel=2,
            )

        if streaming is None:
            streaming = total_tokens > self.STREAMING_TOKEN_THRESHOLD
        if streaming and not sequential:

            def walk_chunks(_pass):
                return self._walk_chunks(num_walks, walk_length)

            timed = Timer("stream walks + train embeddings", verbose)(
                sgns.train_streaming
            )
            return timed(
                walk_chunks, self.num_nodes, config, verbose,
                max_steps=max_steps, device=self.device,
            )

        timed_walk = Timer("generate walks", verbose)(self.simulate_walks_device)
        walks, eff_len = timed_walk(num_walks, walk_length)
        if sequential:
            timed_train = Timer("train embeddings (sequential)", verbose)(
                sgns.train_sequential
            )
            return timed_train(
                walks, eff_len, self.num_nodes, config,
                workers=self.workers, verbose=verbose,
            )
        timed_train = Timer("train embeddings", verbose)(sgns.train)
        return timed_train(
            walks, eff_len, self.num_nodes, config,
            max_steps=max_steps, verbose=verbose,
        )
