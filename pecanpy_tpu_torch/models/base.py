"""Walk-mode base class: device-graph management, walk driver, embedding.

Counterpart of ``pecanpy_tpu/models/base.py``: the constructor parameters
``p, q, workers, verbose, extend, gamma, random_state``, the
``simulate_walks`` / ``embed`` entry points, the one-shot
``preprocess_transition_probs`` hook and the reference's scalar callbacks
(``get_noise_thresholds``, ``get_has_nbrs``, ``get_move_forward``), plus
an explicit ``device``. Walks
run batched on the device (``models/engine.py``); embeddings train with
the batched SGNS trainer (``models/sgns.py``) on this mode's device, or
with ``trainer="sequential"`` on the host with the native gensim loop.

Reproducibility: a fixed ``random_state`` fixes the start-node shuffle
(the same numpy shuffle as the JAX package, so walk *sets* line up) and
the torch generators of every walk chunk and training step. The port and
the JAX package agree in distribution, not sample for sample.
"""
import dataclasses
import itertools
import os
import time
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from pecanpy_tpu_torch.graph import BaseGraph
from pecanpy_tpu_torch.models import engine
from pecanpy_tpu_torch.ops import layout
from pecanpy_tpu_torch.ops.layout import DEFAULT_DEGREE_CAP, DeviceCSR
from pecanpy_tpu_torch.typing import Embeddings, HasNbrs, MoveForward
from pecanpy_tpu_torch.utils import trace
from pecanpy_tpu_torch.wrappers import Timer

DEFAULT_WALKER_BATCH = 131072
# hub graphs walk with fewer lanes: the hub walkers' straggler tail (the
# max over lanes of summed geometric retries) grows with the batch
# (``pecanpy_tpu/models/base.py``)
DEFAULT_HUB_WALKER_BATCH = 32768
# the hub walkers' first-order CDF channel, N * dpad * 4 bytes, is built
# up to this size (``Base._want_cdf``)
HUB_CDF_BUDGET = 2 << 30


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


def _amortized() -> bool:
    """The hub engines, unless ``PECANPY_TPU_AMORTIZED=0`` asks for the
    scan engine with the per-step rejection sampler."""
    return os.environ.get("PECANPY_TPU_AMORTIZED", "1") not in ("0", "false")


@dataclasses.dataclass(frozen=True)
class WalkSpec:
    """How a mode walks, on one device and across ranks (``parallel/``).

    A class attribute of each mode (``Base.WALK_SPEC``) that drives its
    ``make_step_fns``, ``_draw_width`` and the engine a graph with hubs
    walks with. Picklable: the mode class travels to spawned ranks by
    reference.

    Args:
        fns: module-level factory ``(p, q, extend) -> (first_fn, step_fn)``.
        hub_engine: hub graphs walk with a hub engine (the OTF modes), not
            the scan engine over ``fns``: the queued one on one device, the
            amortized one across ranks. Under ``PECANPY_TPU_AMORTIZED=0``
            one device takes the scan engine with the per-step sampler.
        hub_draw_width: uniforms a scan-engine step draws on a hub graph.
        edge: the walks run on a row-sharded graph (``partition="edge"``).
    """

    fns: Callable
    hub_engine: bool = False
    hub_draw_width: int = 1
    edge: bool = True

    def step_fns(self, p: float, q: float, extend: bool):
        return self.fns(p, q, extend)

    def uses_hub_engine(self, dg: DeviceCSR) -> bool:
        return self.hub_engine and dg.has_hubs

    def draw_width(self, dg: DeviceCSR) -> int:
        return self.hub_draw_width if dg.has_hubs else 1


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
        self._host_graph: Optional[DeviceCSR] = None
        self._preprocessed: bool = False

    # -- device graph -------------------------------------------------------

    def _build_device_graph(self) -> DeviceCSR:
        raise NotImplementedError

    def get_device_graph(self) -> DeviceCSR:
        """Padded device layout of this graph (built once, cached; the
        build is the job ``pecanpy.layout``)."""
        if self._device_graph is None:
            with trace.job("pecanpy.layout"):
                self._device_graph = self._build_device_graph()
        return self._device_graph

    def get_host_graph(self) -> DeviceCSR:
        """The fused layout with its tables on the CPU (the multi-rank
        path's input: each rank copies the whole graph, or only its row
        slice, onto its own device). Reuses the device layout when it was
        already built; never builds on the card."""
        if self._device_graph is not None:
            return layout.host_graph(self._device_graph)
        if self._host_graph is None:
            self._host_graph = self._build_device_graph(device="cpu")
        return self._host_graph

    # -- mode plug points ----------------------------------------------------

    # the mode's walk (``WalkSpec``); None for modes whose step functions
    # close over per-instance state (PreComp, node2vec++), which have no
    # multi-rank path
    WALK_SPEC: Optional[WalkSpec] = None

    @classmethod
    def walk_spec(cls) -> WalkSpec:
        """The mode's ``WalkSpec``; raises for a mode without one."""
        if cls.WALK_SPEC is None:
            raise ValueError(
                f"mode {cls.__name__!r} has no multichip trainer path (PreComp's "
                "per-edge tables are not replicable at scale; use SparseOTF)"
            )
        return cls.WALK_SPEC

    # the PreComp modes draw first steps from the first-order CDF channel
    _needs_cdf_channel = False

    def make_step_fns(self):
        """Return (first_fn, step_fn), each taking (dg, u, ...)."""
        return self.walk_spec().step_fns(self.p, self.q, self.extend)

    def _want_cdf(self, max_degree: int) -> bool:
        """Should this graph carry the first-order CDF channel?

        The PreComp modes need it. The hub engines' capped-row proposal
        reads it instead of a prefix sum of the wgt row every trial, so a
        mode whose spec takes them gets it on a hub graph, up to
        ``HUB_CDF_BUDGET``. The scan engine has no use for it, and neither
        has the per-step sampler (``PECANPY_TPU_AMORTIZED=0``;
        ``pecanpy_tpu/models/modes.py:_want_cdf``).
        """
        if self._needs_cdf_channel:
            return True
        cap = self.degree_cap
        hubs = cap is not None and max_degree > cap
        if not (hubs and self.WALK_SPEC is not None and self.WALK_SPEC.hub_engine):
            return False
        dpad = -(-cap // layout.LANE) * layout.LANE
        return _amortized() and self.num_nodes * dpad * 4 <= HUB_CDF_BUDGET

    def _draw_width(self) -> int:
        """Uniforms each walk step draws (the step functions' ``u`` is
        [B, width]); 1 unless the mode's spec needs more."""
        if self.WALK_SPEC is None:
            return 1
        return self.WALK_SPEC.draw_width(self.get_device_graph())

    def preprocess_transition_probs(self):
        """Build device-resident state ahead of walking (the device graph)."""
        self.get_device_graph()

    def _preprocess_transition_probs(self):
        if not self._preprocessed:
            self.preprocess_transition_probs()
            self._preprocessed = True

    # -- reference scalar-callback compat ------------------------------------

    def get_noise_thresholds(self) -> np.ndarray:
        """Per-node node2vec+ noise thresholds (``sparse_rw.py:22-35``)."""
        with trace.sync("pecanpy.graph.read"):
            return self.get_device_graph().threshold[:-1].cpu().numpy()

    def get_has_nbrs(self) -> HasNbrs:
        """Scalar has-neighbors callback (reference: ``sparse_rw.py:12-20``).

        Provided for API parity; the batch engines check degrees inline.
        """
        with trace.sync("pecanpy.graph.read"):
            deg = self.get_device_graph().deg.cpu().numpy()

        def has_nbrs(idx: int) -> bool:
            return bool(deg[idx] > 0)

        return has_nbrs

    def get_move_forward(self) -> MoveForward:
        """Scalar single-step callback (reference: ``pecanpy.py:384-440``).

        ``move_forward(cur_idx, prev_idx=None)`` runs this mode's step
        functions on one walker on ``self.device``: the first-order step
        without a prev, the second-order step with one. Useful for
        debugging and API parity, hopeless for throughput (use
        ``simulate_walks_device``). Call n draws from a generator seeded
        from (seed, n) on a stream of its own
        (``engine.MOVE_FORWARD_STREAM``), so two instances with one
        ``random_state`` give one sequence. On a hub graph the OTF modes'
        steps take the per-step sampler's draws from that generator too,
        and their trial blocks take the route every walker takes
        (``rejection.use_trial_kernels``).
        """
        self._preprocess_transition_probs()
        dg = self.get_device_graph()
        first_fn, step_fn = self.make_step_fns()
        width = self._draw_width()
        sampler = self._uses_step_sampler()
        seed = self._seed()
        calls = itertools.count()

        def node(idx: int) -> torch.Tensor:
            with trace.sync("pecanpy.walk.move_forward_upload"):
                return torch.tensor([idx], dtype=torch.int32, device=self.device)

        def move_forward(cur_idx: int, prev_idx: Optional[int] = None) -> int:
            draws = engine.SamplerDrawStream(
                seed, (engine.MOVE_FORWARD_STREAM, next(calls)), self.device,
                engine.MOVE_FORWARD_STREAM,
            )
            u = torch.rand((1, width), generator=draws.gen, device=self.device)
            extra = (draws,) if sampler else ()
            cur = node(cur_idx)
            cur_rows = dg.gather_rows(cur)
            if prev_idx is None:
                nxt = first_fn(dg, u, cur, cur_rows, *extra)
            else:
                prev = node(prev_idx)
                nxt = step_fn(dg, u, cur, prev, cur_rows, dg.gather_rows(prev), *extra)
            with trace.sync("pecanpy.walk.move_forward_read"):
                return int(nxt[0])

        return move_forward

    # -- walk driver ---------------------------------------------------------

    def _resolved_walker_batch(self) -> int:
        if self.walker_batch is not None:
            return self.walker_batch
        if self.get_device_graph().has_hubs:
            return DEFAULT_HUB_WALKER_BATCH
        return DEFAULT_WALKER_BATCH

    def _uses_step_sampler(self) -> bool:
        """Does this mode walk this graph with a hub engine
        (``WalkSpec.uses_hub_engine``)? Its step functions then take the
        per-step rejection sampler's draws, where they run."""
        spec = self.WALK_SPEC
        return spec is not None and spec.uses_hub_engine(self.get_device_graph())

    def _walks_queued(self) -> bool:
        """Does this graph walk with the queued hub engine: a hub engine
        applies, and ``PECANPY_TPU_AMORTIZED`` is not 0?"""
        return self._uses_step_sampler() and _amortized()

    def _walk_queue_factor(self) -> int:
        """Walks per chunk, in units of walker lanes: the queued engine
        amortizes its straggler tail over the whole chunk."""
        return engine.HUB_QUEUE_FACTOR if self._walks_queued() else 1

    def _sampler_draws(self, chunk_idx: int) -> Optional[engine.StepDrawFn]:
        """The per-step rejection sampler's draws of one walk chunk, or
        None for modes and graphs that do not use it."""
        if not self._uses_step_sampler():
            return None
        stream = engine.SamplerDrawStream(self._seed(), chunk_idx, self.device)
        return lambda step: stream

    def _make_walk_runner(self, walk_length: int):
        """The (dg, start, chunk index) -> (walks, eff) walk callable.

        The queued hub engine (``_walks_queued``) with a ``TrialDrawStream``
        of ``engine.HUB_TRIALS`` trials a round, seeded from (seed, chunk
        index); else the scan engine over this mode's step functions, fed
        by ``engine.walk_uniforms(seed, chunk index, width)`` and, where
        the mode uses the per-step sampler, ``_sampler_draws``.
        """
        if self._walks_queued():
            p, q, extend = self.p, self.q, self.extend
            lanes = self._resolved_walker_batch()

            def run_queued(dg, start, chunk_idx):
                draws = engine.TrialDrawStream(
                    self._seed(), chunk_idx, engine.HUB_TRIALS, self.device)
                return engine.generate_walks_queued(
                    dg, start, draws, walk_length, p, q, extend, lanes=lanes)

            return run_queued
        first_fn, step_fn = self.make_step_fns()
        width = self._draw_width()

        def run(dg, start, chunk_idx):
            u = engine.walk_uniforms(
                self._seed(), chunk_idx, walk_length, start.shape[0], self.device,
                width,
            )
            return engine.generate_walks(
                dg,
                lambda uu, cur, rows, *d: first_fn(dg, uu, cur, rows, *d),
                lambda uu, cur, prev, cr, pr, *d: step_fn(dg, uu, cur, prev, cr, pr, *d),
                start,
                u,
                walk_length,
                self._sampler_draws(chunk_idx),
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
        trainer's passes rely on. Each chunk's work is the span
        ``pecanpy.walk.chunk``, closed before the chunk is yielded.
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
            with trace.span("pecanpy.walk.chunk"):
                with trace.sync("pecanpy.walk.start_upload"):
                    start = torch.from_numpy(starts[lo : lo + chunk]).to(self.device)
                walks, eff = run(dg, start, i)
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

    @trace.job("pecanpy.walks")
    def simulate_walks_device(
        self, num_walks: int, walk_length: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generate all walks on the device.

        Returns:
            walks: [num_walks * N, walk_length + 1] int32 node indices.
            eff_len: [num_walks * N] int32 effective walk lengths.

        The call is the job ``pecanpy.walks`` (``utils/trace.py``).
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
        with trace.sync("pecanpy.walk.read"):
            walks = walks.cpu().numpy()
        with trace.sync("pecanpy.walk.read"):
            eff_len = eff_len.cpu().numpy()
        ids = self.nodes
        return [
            [ids[node] for node in row[:n]] for row, n in zip(walks, eff_len)
        ]

    # -- embedding -----------------------------------------------------------

    # tokens above which embed() streams walks instead of storing them
    STREAMING_TOKEN_THRESHOLD = 100_000_000

    @trace.job("pecanpy.embed")
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
        to the full plan. ``checkpoint_dir`` snapshots the training state
        every ``checkpoint_every`` chunk-steps and resumes from the latest
        snapshot when one exists, bit-identical to an uninterrupted run
        (``models/sgns.py``, ``utils/checkpoint.py``).

        ``trainer="sequential"`` walks on this mode's device, then trains
        on the host with gensim's exact sequential loop (native C++,
        hogwild over ``self.workers`` threads): the quality reference, at
        host CPU speed, for small graphs. It takes neither
        ``n_devices > 1``, ``streaming=True`` nor ``checkpoint_dir``
        (``ValueError``).

        ``n_devices > 1`` trains on that many ranks (``parallel/``):
        walkers split over ``n_devices / model_parallel`` data ranks, the
        tables split along ``dim`` over ``model_parallel`` ranks, and the
        graph replicated or row-sharded (``partition``; "auto" shards once
        its tables exceed ``PECANPY_TPU_REPLICATED_BUDGET_MB``, default
        half a card's memory). In a process without a process group it
        spawns the ranks and returns rank 0's embeddings; inside an
        initialized group (``parallel.multihost.initialize``, torchrun)
        every rank runs the call in place and gets the embeddings. Ranks
        take ``cuda:(rank % device_count)`` (or the CPU with
        ``device="cpu"``); ranks that share a card need
        ``PECANPY_TPU_DIST_BACKEND=gloo``.

        The call is the job ``pecanpy.embed`` (``utils/trace.py``).
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
        total_tokens = self.num_nodes * num_walks * (walk_length + 1)
        config = self._sgns_config(
            dim, window_size, epochs, table_dtype, batch_walks, total_tokens,
            sequential,
        )

        if n_devices is not None and n_devices > 1:
            return self._embed_multichip(
                config, n_devices, model_parallel, partition, num_walks,
                walk_length, epochs, verbose, checkpoint_dir, checkpoint_every,
                max_steps,
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
                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
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
        timed_train = Timer("train embeddings", verbose)(self._train_device)
        return timed_train(
            walks, eff_len, config, verbose, checkpoint_dir, checkpoint_every,
            max_steps,
        )

    def _sgns_config(
        self, dim, window_size, epochs, table_dtype, batch_walks, total_tokens,
        sequential=False,
    ):
        """The trainer config of an embedding run over ``total_tokens``,
        with the advisories on its size: ``embed`` and the CLI's
        ``learn_embeddings`` both decide them here."""
        from pecanpy_tpu_torch.models import sgns

        if sequential and total_tokens > 5e7:
            warnings.warn(
                f"trainer='sequential' trains ~{total_tokens:.1e} tokens on "
                "host CPU threads: expect minutes to hours; the batched "
                "trainer is about two orders of magnitude faster at this "
                "scale",
                stacklevel=3,
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
                stacklevel=3,
            )
        return sgns.SGNSConfig(
            dim=dim,
            window=window_size,
            epochs=epochs,
            seed=self.random_state,
            table_dtype=table_dtype,
            batch_walks=batch_walks,
        )

    def _train_device(
        self, walks, eff_len, config, verbose, checkpoint_dir, checkpoint_every,
        max_steps,
    ) -> Embeddings:
        """The batched trainer over walks held on the device: ``embed``'s
        non-streaming path and the CLI's ``learn_embeddings``."""
        from pecanpy_tpu_torch.models import sgns

        return sgns.train(
            walks, eff_len, self.num_nodes, config,
            max_steps=max_steps, verbose=verbose,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        )

    def _embed_multichip(
        self, config, n_devices, model_parallel, partition, num_walks,
        walk_length, epochs, verbose, checkpoint_dir, checkpoint_every,
        max_steps,
    ) -> Embeddings:
        """``embed(n_devices > 1)``: the streaming pipeline of
        ``parallel/train.py`` on ``n_devices`` ranks (JAX ``base.py``'s
        multichip branch)."""
        import torch.distributed as dist

        from pecanpy_tpu_torch.parallel import launch, mesh as mesh_lib, train

        mode = type(self)
        spec = mode.walk_spec()  # before any rank starts
        mesh_lib.mesh_grid(n_devices, model_parallel)
        host = self.get_host_graph()
        partition = train.resolve_partition(
            partition,
            layout.graph_table_bytes(host),
            n_devices // model_parallel,
            edge_supported=spec.edge,
            device=mesh_lib.rank_device(0, self.device),
        )
        if verbose:
            print(f"multichip graph partition: {partition}", flush=True)
        trainer_args = (host, config, walk_length, self.p, self.q, self.extend, mode, partition)
        kwargs = dict(
            epochs=epochs, verbose=verbose, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, max_steps=max_steps,
        )
        timer = Timer("multichip walks + training", verbose)
        if dist.is_initialized():  # every rank runs this call in place
            mesh = mesh_lib.make_mesh(n_devices, model_parallel, device=self.device)
            # one seed for the world: with random_state=None each process
            # would draw its own, and with it its own shuffle, init and walks
            with trace.sync("pecanpy.parallel.seed_upload"):
                seed = torch.tensor(
                    [self._seed()], dtype=torch.int64, device=mesh.device)
            dist.broadcast(seed, src=0)
            with trace.sync("pecanpy.parallel.seed_read"):
                self._resolved_seed = int(seed)
            trainer = train.MultichipTrainer(mesh, *trainer_args)
            return timer(train.train_streaming_multichip)(
                trainer, self._start_nodes(num_walks), seed=self._seed(), **kwargs
            )
        return timer(launch.spawn)(
            train.embed_rank, n_devices, (trainer_args, self._start_nodes(num_walks)),
            dict(kwargs, seed=self._seed()), model_parallel=model_parallel,
            device=self.device,
        )[0]
