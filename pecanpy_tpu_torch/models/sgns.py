"""Batched skip-gram negative-sampling (SGNS) trainer.

Counterpart of ``pecanpy_tpu/models/sgns.py`` (single device). The
training recipe mirrors gensim's skip-gram path:

* vocabulary = graph node indices; frequent-word subsampling with
  gensim's keep probability, applied by pruning each walk before
  windowing;
* per-position reduced windows: effective window ~ U{1..window};
* pair (center, context): the input vector is the context word's row of
  W_in, the output the center word's row of W_out; negatives from the
  unigram^0.75 table, collisions with the center masked out;
* linear learning-rate decay over the total token count.

A chunk of walks trains in one step that never materializes per-pair
rows: each walk token's rows are gathered once, window interactions are
banded batched matmuls over ``[T, T]`` score matrices, negatives come from
a per-step pool of unigram draws in a k-major stripe assignment, and the
per-row updates go through ``ops.apply`` (two table passes per step, the
hand-written CUDA applier on a GPU).

Random draws: every step takes its draws as one ``StepDraws``, derived
from the config seed and the global step index alone (``draw_step``), so
any split of the run (streaming buffers, ``max_steps``, a resume from a
checkpoint) replays the same trajectory. Tests hand in the JAX key tree's
numbers instead.

Checkpoints (``checkpoint_dir``): both trainers snapshot the tables every
``checkpoint_every`` chunk-steps (``utils/checkpoint.py``) and, when the
directory holds a snapshot, resume from the latest one: the cursor
replays without the work, so a resumed run ends bit-identical to an
uninterrupted one.
"""
import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from pecanpy_tpu_torch.ops.apply import apply_mean_updates, apply_mean_updates_two
from pecanpy_tpu_torch.utils import cudagraph, trace
from pecanpy_tpu_torch.utils.checkpoint import SGNSCheckpointer, verify_rng_scheme

# Version tag of the port's draw derivation: walk chunks from
# SeedSequence([seed, chunk]) (models/engine.py; the per-step hub sampler
# from SeedSequence([seed, chunk, 1])), chunk-step draws from
# SeedSequence([seed, 1, g]) (``draw_step``). Stamped into every
# checkpoint; resume refuses a mismatch (``verify_rng_scheme``). The JAX
# package's key tree is another scheme ("single-span-foldin-v1").
RNG_SCHEME = "torch-seedsequence-v1"


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    """Hyperparameters; defaults match the reference CLI / gensim defaults.

    ``batch_walks=None`` resolves per ``resolve_batch_walks``.
    ``update_cap=None`` resolves to ``2 * window`` pair-steps per row per
    application. ``neg_pool`` is the per-step negative pool size (0: one
    direct draw per token and slot). ``table_dtype`` is "auto",
    "float32" or "bfloat16" (see ``resolve_table_dtype``).
    """

    dim: int = 128
    window: int = 10
    negative: int = 5
    epochs: int = 1
    alpha: float = 0.025
    min_alpha: float = 0.0001
    sample: float = 1e-3
    batch_walks: Optional[int] = None
    update_cap: Optional[float] = None
    neg_pool: int = 32768
    table_dtype: str = "auto"
    seed: Optional[int] = None


# "auto" tables at or below this many elements resolve to float32 on any
# device: memory and the table passes are immaterial there, while bf16's
# quality cost is not (the JAX package's threshold).
AUTO_F32_TABLE_ELEMS = 16 * 1024 * 1024


def resolve_table_dtype(
    config: SGNSConfig, num_nodes: Optional[int] = None, device="cpu"
) -> torch.dtype:
    """Concrete table dtype.

    ``"auto"`` picks bfloat16 on a CUDA device for tables above
    ``AUTO_F32_TABLE_ELEMS`` (the CUDA applier writes back with
    stochastic rounding, keeping SGD unbiased) and float32 otherwise.
    Explicit bfloat16 on the CPU warns: the scatter path rounds to
    nearest, and lr-sized steps below the bf16 ulp vanish.
    """
    device = torch.device(device)
    name = config.table_dtype
    if name in (None, "auto"):
        small = (
            num_nodes is not None
            and num_nodes * config.dim <= AUTO_F32_TABLE_ELEMS
        )
        name = "bfloat16" if device.type == "cuda" and not small else "float32"
    elif name == "bfloat16" and device.type != "cuda":
        import warnings

        warnings.warn(
            "bfloat16 tables on the CPU use a round-to-nearest scatter "
            "path; SGD updates smaller than the bf16 ulp are dropped "
            "(quality degrades). Use float32 on the CPU.",
            stacklevel=2,
        )
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown table_dtype {config.table_dtype!r}")
    return getattr(torch, name)


def init_tables(seed: int, num_nodes: int, dim: int, dtype, device):
    """(w_in, w_out): w_in ~ U(-0.5/dim, 0.5/dim) at [N, dim], w_out = 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    bound = 0.5 / dim
    w_in = torch.empty((num_nodes, dim), device=device).uniform_(
        -bound, bound, generator=gen
    )
    w_out = torch.zeros((num_nodes, dim), dtype=dtype, device=device)
    return w_in.to(dtype), w_out


def tables_from_numpy(w_in, w_out, device, dtype=torch.float32):
    """(w_in, w_out) device tables from host arrays (e.g. JAX tables)."""
    return tuple(
        torch.from_numpy(np.array(w, dtype=np.float32)).to(device, dtype)
        for w in (w_in, w_out)
    )


def _count_tokens(
    walks: torch.Tensor, eff_len: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """Occurrence count of every node across the valid walk prefix."""
    valid = torch.arange(walks.shape[1], device=walks.device) < eff_len[:, None]
    return torch.zeros(num_nodes, dtype=torch.float32, device=walks.device).index_add_(
        0, walks.reshape(-1).long(), valid.reshape(-1).to(torch.float32)
    )


def _keep_probs(counts: torch.Tensor, sample: float) -> torch.Tensor:
    """Gensim subsampling keep-probability per word."""
    if sample <= 0:
        return torch.ones_like(counts)
    threshold = sample * counts.sum()
    safe = torch.clamp(counts, min=1.0)
    keep = (torch.sqrt(safe / threshold) + 1.0) * threshold / safe
    return torch.clamp(keep, 0.0, 1.0)


def resolve_batch_walks(
    config: SGNSConfig, num_nodes: int, walk_cols: int
) -> int:
    """Walks per update application (copied from the JAX package).

    Sized so one application carries ~max(2048, N) window pairs.
    """
    if config.batch_walks is not None:
        return config.batch_walks
    target_pairs = max(2048, num_nodes)
    per_walk = max(walk_cols * min(config.window, walk_cols), 1)
    return int(np.clip(-(-target_pairs // per_walk), 1, 4096))


def build_negative_table(
    counts: np.ndarray, size: int = 1 << 22, seed: int = 0
) -> np.ndarray:
    """Shuffled unigram^0.75 sampling table (word2vec InitUnigramTable).

    Copied from ``pecanpy_tpu/models/sgns.py:build_negative_table``.
    """
    counts = np.asarray(counts, dtype=np.float64)
    p = counts**0.75
    p = p / max(p.sum(), 1e-30)
    grid = (np.arange(size) + 0.5) / size
    table = np.searchsorted(np.cumsum(p), grid).astype(np.int32)
    table = np.minimum(table, counts.size - 1)
    np.random.default_rng(seed).shuffle(table)
    return table


def _stripe_bases(k_neg: int, bt: int, m_pool: int) -> list:
    """Per-stripe base offsets into the negative pool, pairwise distinct
    mod ``m_pool`` (copied from ``pecanpy_tpu/models/sgns.py``).

    Stripe k of token n reads pool slot ``(bases[k] + n) % m_pool``.
    """
    bases: list = []
    if k_neg >= m_pool:  # distinctness impossible; degenerate tiny pool
        return [(k * bt + k) % m_pool for k in range(k_neg)]
    used: set = set()
    for k in range(k_neg):
        b = (k * bt + k) % m_pool
        while b in used:
            b = (b + 1) % m_pool
        bases.append(b)
        used.add(b)
    return bases


@functools.lru_cache(maxsize=16)
def _stripe_bases_tensor(k_neg: int, bt: int, m_pool: int, device) -> torch.Tensor:
    """``_stripe_bases`` as a [K] int64 tensor on ``device``, built once a
    shape. Each element is written by a fill, so building it copies
    nothing from host memory and waits on nothing."""
    out = torch.empty(k_neg, dtype=torch.int64, device=device)
    for k, b in enumerate(_stripe_bases(k_neg, bt, m_pool)):
        out[k].fill_(b)
    return out


def _device_offset(pool_off: int, device) -> torch.Tensor:
    """A step's pool offset as the body takes it: a 0-dim int64 tensor on
    ``device``, written by a fill (no copy from host memory)."""
    return torch.full((), pool_off, dtype=torch.int64, device=device)


def _roll_left(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, -off)`` for a 1-D ``x`` and a 0-dim device tensor
    ``off`` in [0, len(x)): a gather, so the offset is read on the device
    and never on the host."""
    n = x.shape[0]
    return x[(torch.arange(n, device=x.device) + off) % n]


def _uses_pool(config: SGNSConfig, bt: int) -> bool:
    """Does a chunk of ``bt`` tokens draw its negatives from the pool?"""
    return bool(config.neg_pool) and bt * config.negative > config.neg_pool


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """Every random number one chunk-step consumes.

    Attributes:
        u_sub: [Wb, T] float32 subsampling uniforms in [0, 1).
        eff_win: [Wb, T] int64 reduced windows in 1..window.
        neg_slots: [M] pool slots into the negative table when the pool
            is on, else [Wb, T, K] direct slots.
        pool_off: pool rotation offset in [0, M) (0 without the pool).
        rng_seed: stochastic-rounding seed in [0, 2^30 - 1).
    """

    u_sub: torch.Tensor
    eff_win: torch.Tensor
    neg_slots: torch.Tensor
    pool_off: int
    rng_seed: int


def draw_step(
    seed: int, g: int, wb: int, t: int, config: SGNSConfig, table_size: int,
    device, data_rank: Optional[int] = None,
) -> StepDraws:
    """The draws of global step ``g``: a pure function of (seed, g), and of
    the data rank on the multi-rank path (``parallel/train.py``)."""
    entropy = [int(seed), 1, int(g)] + ([] if data_rank is None else [int(data_rank)])
    ss = np.random.SeedSequence(entropy)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1)[0]))
    host = np.random.default_rng(ss)
    u_sub = torch.rand((wb, t), generator=gen, device=device)
    eff_win = config.window - torch.randint(
        0, config.window, (wb, t), generator=gen, device=device
    )
    if _uses_pool(config, wb * t):
        slots = torch.randint(
            0, table_size, (config.neg_pool,), generator=gen, device=device
        )
        off = int(host.integers(0, config.neg_pool))
    else:
        slots = torch.randint(
            0, table_size, (wb, t, config.negative), generator=gen,
            device=device,
        )
        off = 0
    return StepDraws(u_sub, eff_win, slots, off, int(host.integers(0, 2**30 - 1)))


def _pair_counts_banded(comp, negs, cnt_v, eff_win, m, window: int):
    """Per-(context j, negative k) trained-pair count minus collisions.

    ``cnt_v[:, :, None] - sum_i pm[b, i, j] * (comp[b, i] == negs[b, j, k])``
    evaluated over the window band (2W shifted [Wb, T, K] compares), never
    materializing a [Wb, T, T, K] tensor.
    """
    wb, t = comp.shape
    ti = torch.arange(t, device=comp.device)
    valid_tok = ti[None, :] < m[:, None]  # [Wb, T]
    pair_cnt = cnt_v[:, :, None].to(torch.float32).expand(negs.shape).clone()
    for d in range(-window, window + 1):
        if d == 0:
            continue
        in_rng = (ti + d >= 0) & (ti + d < t)  # [T] center stays in range
        comp_d = torch.roll(comp, -d, dims=1)  # comp[b, j + d]
        effw_d = torch.roll(eff_win, -d, dims=1)
        valid_d = torch.roll(valid_tok, -d, dims=1)
        band = (abs(d) <= effw_d) & valid_d & valid_tok & in_rng[None, :]
        coll_d = comp_d[:, :, None] == negs  # [Wb, T, K]
        pair_cnt = pair_cnt - (band[:, :, None] & coll_d).to(torch.float32)
    return pair_cnt


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Append ``rows`` zero rows along dim 0."""
    if rows == 0:
        return x
    return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])


def make_step_body(num_nodes: int, config: SGNSConfig, model_group=None, data_group=None,
                   *, _graph: bool = True):
    """Build the per-chunk training step.

    ``step(w_in, w_out, walks, eff_len, keep_prob, neg_table, lr, draws)``
    updates both tables IN PLACE and returns them.

    One device by default. On the multi-rank path (``parallel/train.py``)
    the same arithmetic runs on every rank with three collective hooks
    (``parallel/mesh.py`` groups; JAX: ``model_axis`` / ``data_axis``):

    * ``model_group``: the tables hold this rank's column slice of
      ``dim``; the negative logits and the pair scores are partial dots,
      summed over the model group before the sigmoid;
    * ``data_group``: the walk batch is this data rank's slice; the
      update streams are gathered over the data group (rank 0's first)
      before the two table passes, so every data rank applies the same
      full stream and the tables stay identical across data ranks; the
      stochastic-rounding seed is the data group's minimum.

    With both None the step is the single-device one, bit for bit.

    Steps 1-4 (the update streams) are the span ``pecanpy.sgns.body``;
    the two table passes follow it (``ops/apply.py``'s spans). On a CUDA
    device with both groups None, steps 1-4 run as one CUDA graph
    (``_GraphedBody``), bit-equal to running them op by op; the table
    passes stay eager. ``_graph=False`` is a test seam that keeps steps
    1-4 eager there too.
    """
    window = config.window
    k_neg = config.negative
    cap = (
        config.update_cap
        if config.update_cap is not None
        else 2.0 * config.window
    )

    def body(w_in, w_out, keep_prob, neg_table, walks, eff_len, u_sub, eff_win,
             neg_slots, pool_off):
        """Steps 1-4: the update streams. ``u_sub``, ``eff_win`` and
        ``neg_slots`` are the step's draws, ``pool_off`` its pool offset as
        a 0-dim int64 tensor on the device."""
        wb, t = walks.shape
        dim = w_in.shape[1]
        dev = walks.device
        ti = torch.arange(t, device=dev)

        # 1. Subsample: prune dropped tokens, compact each walk left
        #    (kept tokens first, order stable; the keys are distinct).
        in_walk = ti[None, :] < eff_len[:, None]
        keep = in_walk & (u_sub < keep_prob[walks.long()])
        pos = ti.expand(wb, t)
        sort_key = torch.where(keep, pos, pos + t)
        comp = walks.gather(1, torch.argsort(sort_key, dim=1))
        m = keep.sum(dim=1)  # [Wb] compacted lengths

        # 2. One row gather per walk token (both tables), upcast to f32.
        comp_l = comp.long()
        v = w_in[comp_l].to(torch.float32)  # [Wb, T, dim]
        uo = w_out[comp_l].to(torch.float32)

        # 3. Negatives. With the pool, pool[s] are iid unigram draws and
        #    the negative of (token n, slot k) is pool slot
        #    (bases[k] + n) % M of the rotated pool: negative rows are
        #    gathered once per pool slot, and everything negative-side
        #    runs over a padded [reps, M, dim] view of the token rows.
        bt = wb * t
        m_pool = config.neg_pool
        use_pool = _uses_pool(config, bt)
        v_flat = v.reshape(bt, dim)
        if use_pool:
            pool = neg_table[neg_slots.long()]  # [M]
            pool_r = _roll_left(pool, pool_off)
            pool_rows = w_out[pool_r.long()].to(torch.float32)  # [M, dim]
            reps = -(-bt // m_pool)
            pad_bt = reps * m_pool - bt
            bases = _stripe_bases(k_neg, bt, m_pool)
            v_pad = _pad_rows(v_flat, pad_bt).reshape(reps, m_pool, dim)
            rolled = torch.stack(
                [torch.roll(pool_rows, -b, dims=0) for b in bases]
            )  # [K, M, dim]
            neg_logits = torch.einsum("rmd,kmd->krm", v_pad, rolled).reshape(
                k_neg, reps * m_pool
            )[:, :bt]  # [K, BT]
            bases_t = _stripe_bases_tensor(k_neg, bt, m_pool, dev)
            slot = (bases_t[:, None] + torch.arange(bt, device=dev)[None, :]) % m_pool
            negs = pool_r[slot].T.reshape(wb, t, k_neg)  # ids (collisions)
        else:
            negs = neg_table[neg_slots.long()]  # [Wb, T, K]
            u_neg = w_out[negs.long()].to(torch.float32)  # [Wb, T, K, dim]
            neg_logits = torch.einsum("btd,btkd->btk", v, u_neg)
        if model_group is not None:  # partial dots over the dim slices
            neg_logits = model_group.all_reduce(neg_logits)
        g_neg = torch.sigmoid(neg_logits)

        # 4. Window interactions as banded batched matmuls:
        #    pm[b, i, j] = pair (center i, context j) is trained.
        dist = (ti[:, None] - ti[None, :]).abs()  # [T, T]
        valid_tok = ti[None, :] < m[:, None]  # [Wb, T]
        pm = (
            (dist[None] >= 1)
            & (dist[None] <= eff_win[:, :, None])  # window of the center i
            & valid_tok[:, :, None]
            & valid_tok[:, None, :]
        ).to(torch.float32)  # [Wb, T, T]
        scores = torch.bmm(uo, v.transpose(1, 2))  # s[i, j] = v(j) . u(i)
        if model_group is not None:
            scores = model_group.all_reduce(scores)
        g_pos = (torch.sigmoid(scores) - 1.0) * pm
        du = torch.bmm(g_pos, v)
        dv = torch.bmm(g_pos.transpose(1, 2), uo)
        cnt_u = pm.sum(dim=2)  # pairs as center
        cnt_v = pm.sum(dim=1)  # pairs as context

        # every pair (i, j) contributes g_neg[j, k] unless negative k
        # collides with the pair's center token i
        pair_cnt = _pair_counts_banded(comp, negs, cnt_v, eff_win, m, window)

        ids_tok = comp.reshape(-1)
        if use_pool:
            a_km = g_neg * pair_cnt.reshape(bt, k_neg).T  # [K, BT]
            a_pad = _pad_rows(a_km.T, pad_bt).T.reshape(k_neg, reps, m_pool)
            dv_neg = torch.einsum("krm,kmd->rmd", a_pad, rolled)
            dv = dv + dv_neg.reshape(-1, dim)[:bt].reshape(wb, t, dim)
            # negative updates pre-aggregated per pool slot: stripe k's
            # token n feeds slot (n + bases[k]) % M
            c_km = pair_cnt.reshape(bt, k_neg).T
            c_pad = _pad_rows(c_km.T, pad_bt).T.reshape(k_neg, reps, m_pool)
            by_mod = torch.einsum("krm,rmd->kmd", a_pad, v_pad)  # [K, M, dim]
            c_mod = c_pad.sum(dim=1)  # [K, M]
            du_neg_flat = sum(
                torch.roll(by_mod[k], bases[k], dims=0) for k in range(k_neg)
            )
            c_v_flat = sum(
                torch.roll(c_mod[k], bases[k], dims=0) for k in range(k_neg)
            )
            negs_flat = pool_r
        else:
            a_v = g_neg * pair_cnt
            dv = dv + torch.einsum("btk,btkd->btd", a_v, u_neg)
            du_neg_flat = (a_v[..., None] * v[:, :, None, :]).reshape(-1, dim)
            c_v_flat = pair_cnt.reshape(-1)
            negs_flat = negs.reshape(-1)

        # 5. (in ``step``) Apply: context gradients into W_in; W_out takes
        #    the center stream and the negative stream in ONE merged pass,
        #    as separate normalization groups.
        streams = [
            ids_tok, dv.reshape(-1, dim), cnt_v.reshape(-1), du.reshape(-1, dim),
            cnt_u.reshape(-1), negs_flat, du_neg_flat, c_v_flat,
        ]
        if data_group is not None:  # the full stream on every data rank
            streams = [data_group.all_gather(x) for x in streams]
        return streams

    graphed = (
        _GraphedBody(body) if _graph and model_group is None and data_group is None
        else None
    )

    def step(w_in, w_out, walks, eff_len, keep_prob, neg_table, lr,
             draws: StepDraws):
        with trace.span("pecanpy.sgns.body"):
            rng_seed = draws.rng_seed
            if data_group is not None:  # common to the data ranks (bf16 rounding)
                with trace.sync("pecanpy.sgns.seed_upload"):
                    seed_t = torch.tensor(rng_seed, device=walks.device)
                seed_t = data_group.all_reduce(seed_t, "min")
                with trace.sync("pecanpy.sgns.seed_read"):
                    rng_seed = int(seed_t)
            tables = (w_in, w_out, keep_prob, neg_table)
            inputs = (walks, eff_len, draws.u_sub, draws.eff_win, draws.neg_slots)
            if graphed is not None and walks.device.type == "cuda":
                streams = graphed(tables, inputs, draws.pool_off)
            else:
                streams = body(*tables, *inputs, _device_offset(draws.pool_off, walks.device))
        ids_tok, dv_f, cnt_v_f, du_f, cnt_u_f, negs_flat, du_neg_flat, c_v_flat = streams
        apply_mean_updates(
            w_in, ids_tok, dv_f, cnt_v_f, lr, cap=cap, rng_seed=rng_seed,
        )
        apply_mean_updates_two(
            w_out, ids_tok, du_f, cnt_u_f,
            negs_flat, du_neg_flat, c_v_flat, lr,
            cap_a=cap, cap_b=cap, rng_seed=rng_seed + 2,
        )
        return w_in, w_out

    return step


class _GraphedBody:
    """The SGNS step body replayed from one captured CUDA graph.

    The body is some 300 small ops a step, so op by op the host's launches
    set its pace; a graph replay launches them all at once. The first
    call under a key runs the body eagerly (it warms up cuBLAS, the
    allocator and the cached stripe bases), the second captures it, and
    that call and every later one copy their inputs into the graph's
    static tensors and replay it. The body only reads the tables, so
    capturing it changes nothing, and a replay gives the eager streams
    bit for bit.

    The key is what a capture bakes in: the addresses, shapes and dtypes
    of the tensors the graph reads in place (the tables, ``keep_prob``,
    the negative table) and the shapes and dtypes of the inputs it copies
    (``_run_buffer`` pads every buffer to whole chunks, so a run keeps
    one). A new key drops the graph and starts over with an eager call.
    The graph and its memory pool go with this object, i.e. with the
    step closure that holds it. Counters: ``sgns.graph_captures``,
    ``sgns.graph_replays`` (chunk-steps whose body was a replay).

    The capture (``cudagraph.capture``) waits on nothing, so nothing in
    a chunk-step, capture included, waits on the device.
    """

    def __init__(self, body):
        self.body = body
        self.key = None
        self.graph = None
        self.static = None  # the copied inputs, then the pool offset
        self.streams = None

    def __call__(self, tables, inputs, pool_off: int):
        key = tuple((t.data_ptr(), t.shape, t.stride(), t.dtype) for t in tables) + tuple(
            (t.shape, t.dtype) for t in inputs)
        if key != self.key:
            self.graph = self.static = self.streams = None
            self.key = key
            return self.body(*tables, *inputs, _device_offset(pool_off, inputs[0].device))
        if self.graph is None:
            device = inputs[0].device
            self.static = [t.clone() for t in inputs] + [_device_offset(pool_off, device)]
            self.graph, self.streams = cudagraph.capture(
                lambda: self.body(*tables, *self.static), device)
            trace.count("sgns.graph_captures")
        else:
            for dst, src in zip(self.static, inputs):
                dst.copy_(src)
            self.static[-1].fill_(pool_off)
        self.graph.replay()
        trace.count("sgns.graph_replays")
        return self.streams


def _chunk_lrs(config, eff_sums, done_tokens, total_tokens):
    """Per-chunk learning rates from the token-progress schedule."""
    starts = done_tokens + np.concatenate([[0.0], np.cumsum(eff_sums)[:-1]])
    return np.maximum(
        config.min_alpha,
        config.alpha
        - (config.alpha - config.min_alpha)
        * (starts / max(total_tokens, 1.0)),
    ).astype(np.float32)


def _progress(verbose, t0, done_tokens, total_tokens):
    if not verbose:
        return
    rate = done_tokens / max(time.perf_counter() - t0, 1e-9)
    print(
        f"SGNS: {done_tokens:.3e}/{total_tokens:.3e} tokens "
        f"({100.0 * done_tokens / max(total_tokens, 1.0):.1f}%, "
        f"{rate:.2e} tokens/s)",
        flush=True,
    )


DrawFn = Callable[[int, int, int], StepDraws]


def _setup_tables(config, num_nodes, device, seed, _tables):
    if _tables is not None:
        return _tables
    table_dtype = resolve_table_dtype(config, num_nodes, device)
    return init_tables(seed, num_nodes, config.dim, table_dtype, device)


class _Checkpoints:
    """A trainer's checkpoint directory: the snapshot it resumes from and
    the snapshots it writes every ``every`` chunk-steps."""

    def __init__(self, directory: str, every: int):
        if every < 1:
            raise ValueError(f"checkpoint_every must be at least 1, got {every}")
        self.every = every
        self.ckpt = SGNSCheckpointer(directory)

    def restore(self, w_in, w_out):
        """Copy the latest snapshot into the tables (on their device, in
        their dtype); returns the chunk-steps it covers (0: fresh start)."""
        if self.ckpt.latest_step() is None:
            return 0
        r_in, r_out, meta = self.ckpt.restore()
        verify_rng_scheme(meta, RNG_SCHEME)
        for table, saved in ((w_in, r_in), (w_out, r_out)):
            if saved.shape != table.shape:
                raise ValueError(
                    f"checkpoint table {tuple(saved.shape)} does not match "
                    f"this run's {tuple(table.shape)}"
                )
            with trace.sync("pecanpy.sgns.table_upload"):
                table.copy_(saved.to(device=table.device, dtype=table.dtype))
        return int(meta["next_step"])

    def after_step(self, step_idx, w_in, w_out):
        """Snapshot once ``step_idx`` chunk-steps are done, at a boundary."""
        if step_idx % self.every == 0:
            self.ckpt.save(
                step_idx, w_in, w_out,
                {"next_step": step_idx, "rng_scheme": RNG_SCHEME},
            )


def _run_buffer(step, w_in, w_out, walks, eff_len, eff_host, chunk, keep_prob,
                neg_table, lrs_of, g0, draw: DrawFn, budget, step0, resume=0,
                ckpt: Optional[_Checkpoints] = None):
    """Train the chunks of one walk buffer; returns (chunk-steps covered,
    tokens they covered).

    ``lrs_of(eff_sums)`` gives the buffer's per-chunk learning rates,
    ``budget`` the chunk-steps still allowed (None: unlimited). ``step0``
    is the run's chunk-step count before this buffer: chunk-steps below
    ``resume`` are already in the restored tables, so the cursor passes
    them without the work (their lrs, draws and tokens stay as in an
    uninterrupted run), and ``ckpt`` snapshots after each chunk-step that
    ends on its boundary. Each chunk-step is the span
    ``pecanpy.sgns.chunk_step``: its draws (``pecanpy.sgns.draw``), then
    the step.
    """
    n_chunks = -(-walks.shape[0] // chunk)
    pad = n_chunks * chunk - walks.shape[0]
    walks, eff_len = _pad_rows(walks, pad), _pad_rows(eff_len, pad)
    eff_sums = np.add.reduceat(
        np.pad(eff_host, (0, pad)).astype(np.float64),
        np.arange(n_chunks) * chunk,
    )
    lrs = lrs_of(eff_sums)
    t = walks.shape[1]
    steps = n_chunks if budget is None else min(n_chunks, budget)
    for i in range(min(max(resume - step0, 0), steps), steps):
        sl = slice(i * chunk, (i + 1) * chunk)
        with trace.span("pecanpy.sgns.chunk_step"):
            with trace.span("pecanpy.sgns.draw"):
                draws = draw(g0 + i, chunk, t)
            step(w_in, w_out, walks[sl], eff_len[sl], keep_prob, neg_table,
                 float(lrs[i]), draws)
        if ckpt is not None:
            ckpt.after_step(step0 + i + 1, w_in, w_out)
    return steps, float(eff_sums[:steps].sum())


def train(
    walks: torch.Tensor,
    eff_len: torch.Tensor,
    num_nodes: int,
    config: SGNSConfig = SGNSConfig(),
    max_steps: Optional[int] = None,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    *,
    _tables=None,
    _draws: Optional[DrawFn] = None,
) -> np.ndarray:
    """Train SGNS embeddings from device walks.

    Args:
        walks: [W, T] int32 walk matrix (T = walk_length + 1), on the
            device the tables should live on.
        eff_len: [W] int32 effective walk lengths.
        num_nodes: vocabulary size N.
        config: hyperparameters.
        max_steps: stop after this many chunk-steps (the lr schedule
            stays pinned to the full plan).
        checkpoint_dir: if set, snapshot both tables every
            ``checkpoint_every`` chunk-steps and resume from the latest
            snapshot when one exists (bit-identical to an uninterrupted
            run; combine with ``max_steps`` to split a run).
        checkpoint_every: snapshot period in chunk-steps.
        _tables / _draws: test seams replacing the initial tables and
            the per-step draws (``_draws(g, wb, t) -> StepDraws``).

    Returns:
        [N, dim] float32 input-embedding matrix, row i = node i.
    """
    device = walks.device
    walks = walks.to(torch.int32)
    eff_len = eff_len.to(torch.int32)
    seed = config.seed if config.seed is not None else 0

    with trace.span("pecanpy.sgns.count_pass"):
        counts = _count_tokens(walks, eff_len, num_nodes)
        keep_prob = _keep_probs(counts, config.sample)
        with trace.sync("pecanpy.sgns.counts_read"):
            counts_host = counts.cpu().numpy()
        neg_host = build_negative_table(counts_host, seed=seed)
        with trace.sync("pecanpy.sgns.neg_upload"):
            neg_table = torch.from_numpy(neg_host).to(device)
    w_in, w_out = _setup_tables(config, num_nodes, device, seed, _tables)
    ckpt, resume = None, 0
    if checkpoint_dir is not None:
        ckpt = _Checkpoints(checkpoint_dir, checkpoint_every)
        resume = ckpt.restore(w_in, w_out)
    draw = _draws or (
        lambda g, wb, t: draw_step(
            seed, g, wb, t, config, neg_table.shape[0], device
        )
    )

    chunk = min(resolve_batch_walks(config, num_nodes, walks.shape[1]), walks.shape[0])
    step = make_step_body(num_nodes, config)
    with trace.sync("pecanpy.sgns.eff_read"):
        eff_host = eff_len.cpu().numpy()
    total_tokens = float(eff_host.sum()) * config.epochs
    n_chunks = -(-walks.shape[0] // chunk)

    done_tokens = 0.0
    step_idx = 0
    t_start = time.perf_counter()
    for epoch in range(config.epochs):
        budget = None if max_steps is None else max_steps - step_idx
        if budget is not None and budget <= 0:
            break
        with trace.span("pecanpy.sgns.epoch"):
            steps, tokens = _run_buffer(
                step, w_in, w_out, walks, eff_len, eff_host, chunk, keep_prob,
                neg_table,
                lambda s: _chunk_lrs(config, s, done_tokens, total_tokens),
                epoch * n_chunks, draw, budget, step_idx, resume, ckpt,
            )
        step_idx += steps
        done_tokens += tokens
        _progress(verbose, t_start, done_tokens, total_tokens)
    return _read_table(w_in)


def _read_table(w_in: torch.Tensor) -> np.ndarray:
    """The trained W_in as a host float32 array."""
    with trace.sync("pecanpy.sgns.table_read"):
        return w_in.to(torch.float32).cpu().numpy()


def _prefetch_iter(it, depth: int = 1):
    """Yield items while keeping ``depth`` future items already pulled.

    Pulling a walk chunk enqueues its device work, so a one-deep
    lookahead queues the walks of buffer i+1 behind buffer i's training.
    The yielded values are unchanged; only the enqueue order shifts.
    """
    buf = deque()
    for item in it:
        buf.append(item)
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def train_streaming(
    walk_chunks,
    num_nodes: int,
    config: SGNSConfig = SGNSConfig(),
    verbose: bool = False,
    max_steps: Optional[int] = None,
    cache_walks_bytes: Optional[int] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    *,
    _tables=None,
    _draws: Optional[DrawFn] = None,
) -> np.ndarray:
    """Two-pass streaming trainer: walks regenerated OR device-cached.

    Pass 1 sweeps the walk stream once for the vocabulary statistics
    (token counts -> subsampling probabilities and the negative table);
    each epoch then trains on the identical stream. The vocab pass caches
    the walk chunks on the device up to ``cache_walks_bytes`` (None: 4
    GiB, env ``PECANPY_TPU_WALK_CACHE_MB``; 0 disables) and later passes
    replay the cache; past the budget every pass regenerates from the
    (deterministic) generator. Either way the values streamed are
    identical.

    Args:
        walk_chunks: callable ``(pass_idx) -> iterator`` over
            ``(walks [W, T] int32, eff_len [W] int32)`` device chunks,
            the same stream for every argument.
        num_nodes: vocabulary size N.
        config: hyperparameters (``epochs`` counts training passes).
        max_steps: stop after this many chunk-steps.
        device: where the tables live (None: the first chunk's device).
        checkpoint_dir / checkpoint_every: as in ``train``; a resume
            replays the (deterministic) walk-chunk stream to its cursor.
        _tables / _draws: test seams, as in ``train``.

    Returns:
        [N, dim] float32 input-embedding matrix, row i = node i.
    """
    import os

    seed = config.seed if config.seed is not None else 0
    if cache_walks_bytes is None:
        cache_walks_bytes = (
            int(os.environ.get("PECANPY_TPU_WALK_CACHE_MB", "4096")) * (1 << 20)
        )
    cache: Optional[list] = [] if cache_walks_bytes > 0 else None
    cached_bytes = 0

    def stream(pass_idx):
        if cache is not None and pass_idx >= 0:
            return iter(cache)

        def first_pass():
            nonlocal cache, cached_bytes
            for pair in walk_chunks(pass_idx):
                if cache is not None:
                    cached_bytes += sum(
                        a.numel() * a.element_size() for a in pair
                    )
                    if cached_bytes > cache_walks_bytes:
                        cache = None  # over budget: regenerate instead
                    else:
                        cache.append(pair)
                yield pair

        return first_pass()

    with trace.span("pecanpy.sgns.count_pass"):
        counts = None
        for walks, eff_len in stream(-1):
            if device is None:
                device = walks.device
            if counts is None:
                counts = torch.zeros(num_nodes, dtype=torch.float32, device=device)
            counts += _count_tokens(walks, eff_len, num_nodes)
        keep_prob = _keep_probs(counts, config.sample)
        with trace.sync("pecanpy.sgns.counts_read"):
            counts_host = counts.cpu().numpy()
        neg_host = build_negative_table(counts_host, seed=seed)
        with trace.sync("pecanpy.sgns.neg_upload"):
            neg_table = torch.from_numpy(neg_host).to(device)
        with trace.sync("pecanpy.sgns.tokens_read"):
            total_tokens = float(counts.sum()) * config.epochs

        # with the cache populated, fetch every buffer's eff_len to the host
        # in one transfer instead of one blocking copy per buffer
        host_eff = None
        if cache:
            sizes = [int(e.shape[0]) for _, e in cache]
            with trace.sync("pecanpy.sgns.eff_read"):
                eff_all = torch.cat([e for _, e in cache]).cpu().numpy()
            host_eff = np.split(eff_all, np.cumsum(sizes)[:-1])
    trace.count("sgns.walk_cache_bytes", cached_bytes if cache is not None else 0)

    w_in, w_out = _setup_tables(config, num_nodes, device, seed, _tables)
    ckpt, resume = None, 0
    if checkpoint_dir is not None:
        ckpt = _Checkpoints(checkpoint_dir, checkpoint_every)
        resume = ckpt.restore(w_in, w_out)
    draw = _draws or (
        lambda g, wb, t: draw_step(
            seed, g, wb, t, config, neg_table.shape[0], device
        )
    )
    step = make_step_body(num_nodes, config)

    done_tokens = 0.0
    step_idx = 0
    t_start = time.perf_counter()
    for epoch in range(config.epochs):
        with trace.span("pecanpy.sgns.epoch"):
            buffers = _prefetch_iter(stream(epoch), 1)
            for buf_idx, (walks, eff_len) in enumerate(buffers):
                budget = None if max_steps is None else max_steps - step_idx
                if budget is not None and budget <= 0:
                    break
                with trace.span("pecanpy.sgns.buffer"):
                    chunk = resolve_batch_walks(config, num_nodes, walks.shape[1])
                    if host_eff is not None and buf_idx < len(host_eff):
                        eff_host = host_eff[buf_idx]
                    else:
                        with trace.sync("pecanpy.sgns.eff_read"):
                            eff_host = eff_len.cpu().numpy()
                    steps, tokens = _run_buffer(
                        step, w_in, w_out, walks.to(torch.int32),
                        eff_len.to(torch.int32), eff_host, chunk, keep_prob,
                        neg_table,
                        lambda s: _chunk_lrs(config, s, done_tokens, total_tokens),
                        step_idx, draw, budget, step_idx, resume, ckpt,
                    )
                step_idx += steps
                done_tokens += tokens
                _progress(verbose, t_start, done_tokens, total_tokens)
        if verbose:
            print(
                f"epoch {epoch + 1}/{config.epochs}: "
                f"{done_tokens:.3e} tokens trained"
            )
    return _read_table(w_in)


def train_sequential(
    walks,
    eff_len,
    num_nodes: int,
    config: SGNSConfig = SGNSConfig(),
    workers: int = 1,
    verbose: bool = False,
) -> np.ndarray:
    """Host-side sequential SGNS (gensim loop semantics) on device walks.

    Port of ``pecanpy_tpu/models/sgns.py:train_sequential``. The quality
    reference trainer: per-pair immediate updates, per-token linear lr
    decay, reduced windows, subsampling, unigram^0.75 negatives with
    collision skip, run by the native C++ trainer
    (``native/seqsgns.cpp``). ``workers>1`` races hogwild threads like
    gensim's worker threads (nondeterministic). It runs at host CPU speed,
    so it suits small graphs (below ~5e7 tokens).

    Args:
        walks: [W, T] int32 walk matrix (a device tensor or host array).
        eff_len: [W] int32 effective walk lengths.
        num_nodes: vocabulary size N.
        config: hyperparameters (the batched trainer's object;
            ``table_dtype``, ``neg_pool``, ``update_cap`` and
            ``batch_walks`` are batched-trainer knobs and are ignored).
        workers: hogwild threads; 0 or less resolves to all host CPUs.

    Returns:
        [N, dim] float32 input-embedding matrix, row i = node i.
    """
    import os

    from pecanpy_tpu_torch.native.loader import (
        native_available,
        train_sgns_sequential_native,
    )

    if not native_available():
        raise RuntimeError(
            "trainer='sequential' needs the native toolchain (g++) to "
            "build pecanpy_tpu_torch/native/seqsgns.cpp; use the default "
            "batched trainer instead"
        )
    if isinstance(walks, torch.Tensor):
        with trace.sync("pecanpy.sgns.walks_read"):
            walks = walks.cpu().numpy()
        with trace.sync("pecanpy.sgns.walks_read"):
            eff_len = eff_len.cpu().numpy()
    walks = np.ascontiguousarray(walks, dtype=np.int32)
    eff_len = np.ascontiguousarray(eff_len, dtype=np.int32)
    if workers is None or workers <= 0:
        workers = os.cpu_count() or 1
    seed = config.seed if config.seed is not None else 0

    valid = np.arange(walks.shape[1])[None, :] < eff_len[:, None]
    counts = np.bincount(walks[valid], minlength=num_nodes).astype(np.float32)
    keep_prob = _keep_probs(torch.from_numpy(counts), config.sample).numpy()
    neg_table = build_negative_table(counts, seed=seed)

    rng_init = np.random.default_rng(seed)
    w_in = rng_init.uniform(
        -0.5 / config.dim, 0.5 / config.dim, (num_nodes, config.dim)
    ).astype(np.float32)
    w_out = np.zeros((num_nodes, config.dim), dtype=np.float32)

    total_tokens = float(eff_len.sum()) * config.epochs
    t0 = time.perf_counter()
    pairs = train_sgns_sequential_native(
        walks, eff_len, w_in, w_out, keep_prob, neg_table,
        config.window, config.negative, config.alpha, config.min_alpha,
        total_tokens, config.epochs, seed, workers=workers,
    )
    if verbose:
        dt = max(time.perf_counter() - t0, 1e-9)
        print(
            f"sequential SGNS: {pairs} pairs on {workers} thread(s) "
            f"({pairs / dt:.2e} pairs/s)",
            flush=True,
        )
    return w_in
