"""The batched walk engines.

Counterpart of ``pecanpy_tpu/models/engine.py``:

* ``generate_walks``: B walkers advance in lockstep, one step at a time
  (graphs without hubs). The JAX package compiles the step loop as a
  ``lax.scan``; here it is a Python loop over the ``L - 1`` second-order
  steps, each a handful of tensor ops on the whole batch.
* ``generate_walks_amortized`` and ``generate_walks_queued``: the hub
  walkers, which advance every lane by exact rejection (one trial block
  per round, ``ops/trialkernel.py``) and let a lane that rejects retry in
  the next round while the others move on. ``lax.while_loop`` becomes a
  Python loop that reads the pending count on the host once per block
  of rounds, never once per round. On a card, node2vec+'s blocks (the
  plain trial block's route) are replays of one captured CUDA graph
  (``_GraphedRounds``).

The scan engine carries the fused rows of the current AND previous node
from step to step, so each step performs exactly ONE table gather: the
row of the node just stepped to. The previous node's row is last step's
current row. The hub engines carry only the current rows (their dead
check, the draws' degrees and the atom mass read them): the trial
kernels read both nodes' rows by id.

Every mode plugs in through two step callables:

    first_fn(u, cur, cur_rows)                  -> next   (1st-order)
    step_fn(u, cur, prev, cur_rows, prev_rows)  -> next   (2nd-order)

where ``u`` is the step's [B, width] uniforms (width 1 for most
modes). The OTF modes on a hub graph under ``PECANPY_TPU_AMORTIZED=0``
walk with the scan engine and the per-step rejection sampler
(``rejection.second_order_sample``); ``generate_walks`` then also hands
each callable the step's sampler draws, a ``PhaseDrawFn``, as a last
argument. Walk semantics (reference ``pecanpy.py:180-206``):

* column 0 holds the start node; steps fill columns 1..L;
* a walker whose current node has no neighbors stops: ``eff_len`` is L+1
  when it never stopped, j when the node reached at column j-1 had no
  out-edges;
* dead walkers keep emitting their resting node, which consumers never
  read because they cut each walk at its effective length.
"""
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pecanpy_tpu_torch.ops import rejection, trialkernel
from pecanpy_tpu_torch.ops.layout import DeviceCSR
from pecanpy_tpu_torch.ops.rejection import PhaseDrawFn, RoundDraws, _theta_from
from pecanpy_tpu_torch.utils import cudagraph, trace

FirstFn = Callable[..., torch.Tensor]
StepFn = Callable[..., torch.Tensor]
# draws(round index, [B] int32 degree of each lane's current node) -> the
# round's draws; the amortized engine's first-order draw asks for round
# FIRST and reads its first trial
DrawFn = Callable[[int, torch.Tensor], RoundDraws]
# step index (1 for the first step, s for the step that fills column s) ->
# that step's draws for the per-step sampler (``PhaseDrawFn``); the first
# step asks for phase FIRST and reads the alias draw of its first trial.
# The walkers hand every step one ``SamplerDrawStream`` of the chunk; the
# per-step indirection is a test seam, where each step gets the JAX key
# tree's draws of that step.
StepDrawFn = Callable[[int], PhaseDrawFn]
FIRST = -1
# the per-step sampler's draws of a chunk: a stream beside walk_uniforms'
SAMPLER_STREAM = 1
# the draws of call n of ``Base.get_move_forward``'s callback come from
# SeedSequence([seed, MOVE_FORWARD_STREAM, n, MOVE_FORWARD_STREAM]): its
# second and last words set it apart from the walk chunks' [seed, i], the
# sampler's [seed, i, 1], the SGNS steps' [seed, 1, g(, d)] and the
# multi-rank walks' [seed, 2, i, d] (SeedSequence pads short entropy with 0)
MOVE_FORWARD_STREAM = 3
# trials per round of the hub engines (the JAX walkers' ``trials``)
HUB_TRIALS = 2
# walks per chunk of the queued hub engine, in units of its lanes: it pays
# its straggler tail once per chunk
HUB_QUEUE_FACTOR = 8


def _chunk_generator(seed: int, chunk_idx, device, stream: int = 0) -> torch.Generator:
    """A generator seeded from ``SeedSequence([seed, chunk_idx(, stream)])``;
    ``chunk_idx`` may be a tuple of ints (the multi-rank path's
    ``(stream, batch, data rank)``)."""
    entropy = [seed, *np.atleast_1d(chunk_idx).tolist()] + ([stream] if stream else [])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(entropy).generate_state(1)[0]))
    return gen


def walk_uniforms(
    seed: int, chunk_idx, walk_length: int, batch: int, device, width: int = 1
) -> torch.Tensor:
    """[walk_length, batch, width] uniforms of one walk chunk, ``width``
    per walker and step.

    A pure function of (seed, chunk index), like the JAX package's
    ``fold_in(base_key, i)``, so the streaming trainer's passes see the
    identical chunk stream. Row s feeds step s + 1.
    """
    gen = _chunk_generator(seed, chunk_idx, device)
    return torch.rand((walk_length, batch, width), generator=gen, device=device)


def _round_draws(gen: torch.Generator, trials: int, deg: torch.Tensor) -> RoundDraws:
    """[T, B] uniforms that ``rejection.slot_offsets`` turns into ``kk``,
    then the [T, 4, B] block of the other uniforms."""
    b = deg.shape[0]
    u_kk = torch.rand((trials, b), generator=gen, device=deg.device)
    u = torch.rand((trials, 4, b), generator=gen, device=deg.device)
    return RoundDraws(rejection.slot_offsets(u_kk, deg), u)


class TrialDrawStream:
    """The hub engines' draws for one walk chunk: a ``DrawFn`` backed by
    one ``torch.Generator`` seeded from (seed, chunk index), as
    ``walk_uniforms`` is, so the chunk stream is reproducible. Round FIRST
    draws one trial, every other round ``trials``."""

    def __init__(self, seed: int, chunk_idx, trials: int, device):
        self.gen = _chunk_generator(seed, chunk_idx, device)
        self.trials = trials

    def __call__(self, round_idx: int, deg: torch.Tensor) -> RoundDraws:
        return _round_draws(self.gen, 1 if round_idx == FIRST else self.trials, deg)


class SamplerDrawStream:
    """The per-step sampler's draws for one walk chunk: a ``PhaseDrawFn``
    backed by one ``torch.Generator`` seeded from (seed, chunk index,
    ``stream``), by default ``SAMPLER_STREAM``, a stream beside
    ``walk_uniforms``'. Each call names its trial count."""

    def __init__(self, seed: int, chunk_idx, device, stream: int = SAMPLER_STREAM):
        self.gen = _chunk_generator(seed, chunk_idx, device, stream)

    def __call__(self, phase: int, deg: torch.Tensor, trials: int) -> RoundDraws:
        return _round_draws(self.gen, trials, deg)


def generate_walks(
    graph: DeviceCSR,
    first_fn: FirstFn,
    step_fn: StepFn,
    start: torch.Tensor,
    u: torch.Tensor,
    walk_length: int,
    draws: Optional[StepDrawFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance a batch of walkers ``walk_length`` steps.

    Args:
        graph: fused device CSR.
        first_fn / step_fn: mode-specific transition samplers.
        start: [B] int32 start nodes.
        u: [walk_length, B] or [walk_length, B, width] uniforms in
            [0, 1); row 0 feeds the first step, row s the step that fills
            column s + 1. Each step gets its row as [B, width].
        walk_length: number of steps L.
        draws: the per-step sampler's draws (``StepDrawFn``); when set,
            step s calls its callable with ``draws(s)`` as a last argument.

    Returns:
        walks: [B, L + 1] int32 node indices, column 0 = start.
        eff_len: [B] int32 effective walk lengths in [1, L + 1].
    """
    sentinel = graph.num_nodes
    if u.dim() == 2:
        u = u[:, :, None]
    start = start.to(torch.int32)
    start_rows = graph.gather_rows(start)
    alive = graph.rows_nbr(start_rows)[:, 0] != sentinel
    extra = (lambda s: ()) if draws is None else (lambda s: (draws(s),))
    first = first_fn(u[0], start, start_rows, *extra(1))
    col1 = torch.where(alive, first, start)
    eff = torch.where(alive, walk_length + 1, 1).to(torch.int32)
    cols = [start, col1]
    if walk_length == 1:
        return torch.stack(cols, dim=1), eff

    cur, prev = col1, start
    cur_rows, prev_rows = graph.gather_rows(col1), start_rows
    for step_idx in range(2, walk_length + 1):
        has = graph.rows_nbr(cur_rows)[:, 0] != sentinel
        eff = torch.where(alive & ~has, step_idx, eff).to(torch.int32)
        alive = alive & has
        nxt = step_fn(u[step_idx - 1], cur, prev, cur_rows, prev_rows, *extra(step_idx))
        nxt = torch.where(alive, nxt, cur)
        nxt_rows = graph.gather_rows(nxt)  # THE one gather per step
        prev, cur, prev_rows, cur_rows = cur, nxt, cur_rows, nxt_rows
        cols.append(nxt)
    return torch.stack(cols, dim=1), eff


def _trial_fn(graph: DeviceCSR, p, q, extend, alpha_np, use_cdf):
    """The round's trial block on node ids: the CUDA kernels for node2vec,
    which read both rows by id; the plain block (node2vec+, or a CPU
    graph) on ``cur_rows`` and prev's row gathered here."""

    def run(draws, prev, cur, cur_rows, theta, wp, force_ok=None):
        if not rejection.use_trial_kernels(extend, graph):
            return rejection._trial_block(
                graph, draws.trials(), prev, cur_rows, graph.gather_rows(prev), p, q,
                extend, alpha_np, theta, wp, mode="auto", use_cdf=use_cdf,
                force_ok=force_ok,
            )
        return trialkernel.trial_block_fused(
            graph, draws, prev, cur, p, q, alpha_np, theta, wp, use_cdf=use_cdf,
            force_ok=force_ok,
        )

    return run


class _Lanes(NamedTuple):
    """The queued engine's per-lane state, each [B] but ``cur_rows``
    ([B, row width]): the current and previous node, the current node's
    fused row, the next column to write, whether the lane walks, whether
    it finished and waits for the flush, its effective length, and the
    return-edge atom's mass and weight."""

    cur: torch.Tensor
    prev: torch.Tensor
    cur_rows: torch.Tensor
    step: torch.Tensor
    active: torch.Tensor
    done: torch.Tensor
    eff_l: torch.Tensor
    theta: torch.Tensor
    wp: torch.Tensor


def _queued_rounds(
    graph: DeviceCSR, trial_fn, draw: DrawFn, lanes: _Lanes, buf_l: torch.Tensor,
    t0: int, n: int, walk_length: int, use_atom: bool, undirected: bool,
    excess: float, alpha_np: float,
) -> _Lanes:
    """Rounds ``t0 .. t0 + n - 1`` of ``generate_walks_queued``: returns the
    lanes' new state, and writes each advanced lane's column into
    ``buf_l`` in place. Round t draws ``draw(t, degrees)``."""
    cur, prev, cur_rows, step, active, done, eff_l, theta, wp = lanes
    sentinel = graph.num_nodes
    for t in range(t0, t0 + n):
        # dead-arrival / dead-start check on the current node
        has = graph.rows_nbr(cur_rows)[:, 0] != sentinel
        died = active & ~has & (step <= walk_length)
        eff_l = torch.where(died, step, eff_l)

        # one trial block over every lane; first-order lanes force
        # acceptance of trial 1's proposal (their atom mass is 0)
        needs = active & has & (step <= walk_length)
        x, ok, wx = trial_fn(
            draw(t, graph.rows_degree(cur_rows)), prev, cur, cur_rows,
            theta if use_atom else None, wp if use_atom else None,
            force_ok=step == 1,
        )
        adv = needs & ok
        prev = torch.where(adv, cur, prev)
        cur = torch.where(adv, x, cur)
        col = torch.where(adv, step, walk_length + 1)
        buf_l.scatter_(1, col[:, None].long(), x[:, None])
        step = step + adv.to(torch.int32)

        # finished lanes park until the block-boundary flush + claim
        finished = died | (step > walk_length)
        done = done | (active & finished)
        active = active & ~finished

        cur_rows = graph.gather_rows(cur)  # the one row gather per round
        if use_atom:
            if undirected:
                wp_n = wx
            else:
                _, wp_n = rejection.membership(graph, prev, cur_rows)
            theta_n = _theta_from(graph, wp_n, cur_rows, excess, alpha_np)
            theta = torch.where(adv, theta_n, theta)
            wp = torch.where(adv, wp_n, wp)
    return _Lanes(cur, prev, cur_rows, step, active, done, eff_l, theta, wp)


def _on_card(graph: DeviceCSR) -> bool:
    return graph.fused.device.type == "cuda"


def _replays_rounds(graph: DeviceCSR, draws: DrawFn, extend: bool) -> bool:
    """Whether ``generate_walks_queued`` runs its blocks as replays of a
    captured CUDA graph: on a card, on the plain trial block's route (the
    trial kernels' route stays eager), on a graph held whole (a sharded
    graph's fetches are collectives, which a capture cannot hold), with the
    engine's own draws (an injected provider may read the round index or
    the host)."""
    return (
        _on_card(graph)
        and not rejection.use_trial_kernels(extend, graph)
        and graph.loop_sync is None
        and type(draws) is TrialDrawStream
    )


class _GraphedRounds:
    """A block of the queued engine's rounds replayed from one captured
    CUDA graph.

    Op by op, a node2vec+ round is a few hundred small launches, so the
    host's dispatch sets its pace; a replay launches a block of them at
    once. The graph updates static lane tensors (``lanes``, ``buf_l``) in
    place and draws from a generator of its own, registered with it. A call
    loads its lanes and its chunk generator's state into them
    (``load``), runs its blocks (``run``), writes the block boundary's
    changes back (``store``), and hands the generator's state back to its
    ``TrialDrawStream`` (``unload``), so a replayed chunk draws, and walks,
    exactly as the eager one does.

    The first block under a key runs eagerly (it warms up the allocator and
    every kernel), the second captures the block (``cudagraph.capture``,
    which waits on nothing) and every later block, in this call or the
    next, replays it.
    """

    def __init__(self, lanes: _Lanes, buf_l: torch.Tensor):
        self.lanes = _Lanes(*map(torch.empty_like, lanes))
        self.buf_l = torch.empty_like(buf_l)
        self.gen = torch.Generator(device=buf_l.device)
        self.warm = False
        self.graph = None

    def load(self, lanes: _Lanes, buf_l: torch.Tensor, gen: torch.Generator):
        self.store(lanes)
        self.buf_l.copy_(buf_l)
        self.gen.set_state(gen.get_state())

    def store(self, lanes: _Lanes):
        for dst, src in zip(self.lanes, lanes):
            if dst is not src:
                dst.copy_(src)

    def unload(self, gen: torch.Generator):
        gen.set_state(self.gen.get_state())

    def run(self, run_block) -> bool:
        """Run one block, ``run_block(lanes, buf_l, generator) -> _Lanes``,
        on the static lanes; True when it was a replay."""
        def block():
            self.store(run_block(self.lanes, self.buf_l, self.gen))

        if self.graph is None:
            if not self.warm:
                block()
                self.warm = True
                return False
            self.graph = self._capture(block)
            trace.count("walk.hub_graph_captures")
        self.graph.replay()
        return True

    def _capture(self, fn):
        return cudagraph.capture(fn, self.buf_l.device, (self.gen,))[0]


# (id of the DeviceCSR, lanes, walk length, trials, p, q, extend,
# undirected, block) -> its _GraphedRounds. An entry goes with its graph
# (``weakref.finalize``), so the tables a capture reads stay at their
# addresses for as long as it can be replayed.
_ROUND_GRAPHS = {}


def _graphed_rounds(graph: DeviceCSR, key: tuple, make) -> _GraphedRounds:
    """The process's ``_GraphedRounds`` of ``graph`` under ``key``, made by
    ``make()`` on first use."""
    key = (id(graph),) + key
    entry = _ROUND_GRAPHS.get(key)
    if entry is None or entry[0]() is not graph:
        entry = (weakref.ref(graph), make())
        _ROUND_GRAPHS[key] = entry
        weakref.finalize(graph, _ROUND_GRAPHS.pop, key, None)
    return entry[1]


def generate_walks_queued(
    graph: DeviceCSR,
    starts: torch.Tensor,
    draws: DrawFn,
    walk_length: int,
    p: float,
    q: float,
    extend: bool,
    lanes: int = 32768,
    round_cap_factor: int = 40,
    return_rounds: bool = False,
    undirected: Optional[bool] = None,
    block_rounds: int = 16,
):
    """Persistent-lane hub walker over a walk QUEUE (the hub default).

    B persistent lanes process a queue of W walks: every round each lane
    runs one trial block (propose, bias, accept); a lane that accepts
    advances, one that rejects stays put and retries next round. A lane
    that finishes its walk (L columns written, or stopped on a node with
    no out-edges) parks until the block boundary, where finished rows are
    flushed to the output and the lane claims the next unstarted walk.
    The straggler tail of summed geometric retries is then paid once per
    queue, not once per batch.

    Per-walk semantics (start column, early termination, effective
    lengths, resting-node emission) match ``generate_walks``; each step's
    law is the exact second-order one. First-order steps (column 1 of
    each walk) are trials with ``force_ok`` and zero atom mass.

    The pending count is read on the host once per block of
    ``block_rounds`` rounds (the JAX engine's ``unroll * flush_every``).
    Output row w always serves ``starts[w]``. Each block is the span
    ``pecanpy.walk.hub_block`` (``utils/trace.py``), and the call adds its
    rounds, rounds x lanes and written steps (a device scalar) to the
    counters ``walk.hub_rounds``, ``walk.hub_lane_rounds`` and
    ``walk.hub_steps`` (device sums, read only when asked).

    Where ``_replays_rounds`` holds (node2vec+ on a card, the engine's own
    draws), a block's rounds are replays of one captured CUDA graph
    (``_GraphedRounds``), kept for the process under the graph and the
    call's shapes and parameters; the block boundary stays eager. The
    walks are the eager ones bit for bit. Counters: ``walk.hub_graph_captures``
    and ``walk.hub_graph_rounds`` (rounds run by a replay; counted, 0
    included, by every call).

    Args:
        starts: [W] int32 start nodes (the walk queue; W >= 1).
        draws: the per-round draws (``TrialDrawStream`` or injected).
        lanes: persistent walker lanes B (walks in flight at once).
        round_cap_factor: safety bound on rounds; lanes cut off emit
            their resting node (reachable only at pathological p/q).
        undirected: None takes ``graph.symmetric``; True reuses the
            accepted proposal's weight w(cur, x) as the next return-edge
            weight w(x, cur) instead of a membership probe.

    Returns:
        walks: [W, L + 1] int32; eff_len: [W] int32;
        (+ rounds taken when ``return_rounds``).
    """
    if undirected is None:
        undirected = graph.symmetric
    dev = graph.fused.device
    starts = starts.to(device=dev, dtype=torch.int32)
    w_total = starts.shape[0]
    b = min(lanes, w_total)
    alpha_np = max(1.0, 1.0 / q)
    excess = 1.0 / p - alpha_np
    use_atom = excess > 0.0
    trial_fn = _trial_fn(graph, p, q, extend, alpha_np, "cdf" in graph.channels)
    cols_row = torch.arange(walk_length + 1, dtype=torch.int32, device=dev)

    # lane i starts on walk i; the queue cursor sits past them. Row W of
    # big / eff_big and column L + 1 of buf_l take writes meant for no one.
    wid = torch.arange(b, dtype=torch.int32, device=dev)
    cur = starts[:b].clone()
    big = torch.zeros((w_total + 1, walk_length + 1), dtype=torch.int32, device=dev)
    eff_big = torch.full((w_total + 1,), walk_length + 1, dtype=torch.int32, device=dev)
    buf_l = torch.zeros((b, walk_length + 2), dtype=torch.int32, device=dev)
    buf_l[:, 0] = cur
    state = _Lanes(
        cur=cur,
        prev=cur.clone(),
        cur_rows=graph.gather_rows(cur),
        step=torch.ones(b, dtype=torch.int32, device=dev),  # next column to write
        active=torch.ones(b, dtype=torch.bool, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        eff_l=torch.full((b,), walk_length + 1, dtype=torch.int32, device=dev),
        theta=torch.zeros(b, dtype=torch.float32, device=dev),
        wp=torch.zeros(b, dtype=torch.float32, device=dev),
    )
    with trace.sync("pecanpy.walk.queue_upload"):
        next_w = torch.tensor(b, dtype=torch.int32, device=dev)

    n_batches = -(-w_total // b)
    round_cap = n_batches * walk_length * round_cap_factor + 64
    block = max(int(block_rounds), 1)
    consts = (walk_length, use_atom, undirected, excess, alpha_np)

    graphed = None
    if _replays_rounds(graph, draws, extend):
        trials = draws.trials

        def run_block(states, buf_s, gen):
            def draw(t, deg):  # TrialDrawStream's draws, from the graph's generator
                return _round_draws(gen, trials, deg)

            return _queued_rounds(graph, trial_fn, draw, states, buf_s, 0, block, *consts)

        graphed = _graphed_rounds(
            graph, (b, walk_length, trials, p, q, extend, undirected, block),
            lambda: _GraphedRounds(state, buf_l))
        graphed.load(state, buf_l, draws.gen)
        state, buf_l = graphed.lanes, graphed.buf_l

    t = 0
    replayed = 0
    pending = b
    while pending > 0 and t < round_cap:
        with trace.span("pecanpy.walk.hub_block"):
            if graphed is None:
                state = _queued_rounds(
                    graph, trial_fn, draws, state, buf_l, t, block, *consts)
            elif graphed.run(run_block):
                replayed += block
            t += block

            # block boundary: flush done lanes' rows, then claim new walks
            cur, _, cur_rows, step, active, done, eff_l, theta, wp = state
            tgt = torch.where(done, wid, w_total).long()
            big[tgt] = buf_l[:, : walk_length + 1]
            eff_big[tgt] = eff_l
            rank = torch.cumsum(done.to(torch.int32), dim=0, dtype=torch.int32)
            wid_new = next_w + rank - 1
            claim = done & (wid_new < w_total)
            next_w = torch.clamp(next_w + rank[-1], max=w_total)
            wid = torch.where(claim, wid_new, wid)
            cur = torch.where(
                claim, starts[torch.clamp(wid_new, max=w_total - 1).long()], cur)
            buf_l[:, 0] = torch.where(claim, cur, buf_l[:, 0])
            if use_atom:
                theta = torch.where(claim, 0.0, theta)
                wp = torch.where(claim, 0.0, wp)
            claimed = state._replace(
                cur=cur,
                cur_rows=torch.where(claim[:, None], graph.gather_rows(cur), cur_rows),
                step=torch.where(claim, 1, step),
                active=active | claim,
                done=torch.zeros_like(done),  # flushed; unclaimed lanes retire
                eff_l=torch.where(claim, walk_length + 1, eff_l),
                theta=theta,
                wp=wp,
            )
            if graphed is None:
                state = claimed
            else:
                graphed.store(claimed)
            with trace.sync("pecanpy.walk.pending_read"):
                pending = int(state.active.sum())  # the one host read per block
    if graphed is not None:
        graphed.unload(draws.gen)
    trace.count("walk.hub_graph_rounds", replayed)

    # lanes cut off by the round cap flush their partial rows; their eff
    # records the columns actually written
    active, done, step = state.active, state.done, state.step
    residual = active | done
    eff_l = torch.where(active, torch.minimum(state.eff_l, step), state.eff_l)
    tgt = torch.where(residual, wid, w_total).long()
    big[tgt] = buf_l[:, : walk_length + 1]
    eff_big[tgt] = eff_l
    big, eff_big = big[:w_total], eff_big[:w_total]
    trace.count("walk.hub_rounds", t)
    trace.count("walk.hub_lane_rounds", t * b)
    # every column a walk wrote past its start, read only when asked: sums
    # of rows of 1,024 walks (one full reduction of all of them would stage
    # through a zeroed global buffer, a memset a chunk) and of the rest
    rows = w_total // 1024 * 1024
    if rows:
        trace.count("walk.hub_steps", eff_big[:rows].view(-1, 1024).sum(1))
    if rows < w_total:
        trace.count("walk.hub_steps", eff_big[rows:].sum())
    trace.count("walk.hub_steps", -w_total)
    # resting emission: columns at/past the effective length repeat the
    # walk's final node
    last = big.gather(1, (eff_big[:, None] - 1).long())
    walks = torch.where(cols_row[None, :] < eff_big[:, None], big, last)
    if return_rounds:
        return walks, eff_big, t
    return walks, eff_big


def generate_walks_amortized(
    graph: DeviceCSR,
    start: torch.Tensor,
    draws: DrawFn,
    walk_length: int,
    p: float,
    q: float,
    extend: bool,
    round_cap_factor: int = 40,
    return_rounds: bool = False,
    undirected: Optional[bool] = None,
    unroll: int = 4,
):
    """Per-batch hub walker amortizing rejection retries ACROSS steps.

    Each round every walker runs one trial block; a lane that rejects
    stays put and retries next round with fresh draws while the others
    advance. Walk semantics (start column, early termination, effective
    lengths, resting emission) match ``generate_walks``; the law is the
    exact second-order one, including the return-edge atom that removes
    1/p from the rejection bound. The first step is a plain first-order
    ``propose`` fed by ``draws(FIRST, deg)``. Each block of ``unroll``
    rounds is the span ``pecanpy.walk.hub_block``, and the rounds add to
    the counters of ``generate_walks_queued`` (the steps written in the
    rounds, from column 2, as a device tensor).

    Args:
        start: [B] int32 start nodes.
        draws: the per-round draws (``TrialDrawStream`` or injected).
        round_cap_factor: safety bound, at most ``L * factor + 64``
            rounds; lanes still short of L columns then emit their
            resting node.
        undirected: as in ``generate_walks_queued``.
        unroll: rounds per host read of the pending count.

    Returns:
        walks: [B, L + 1] int32; eff_len: [B] int32;
        (+ rounds taken when ``return_rounds``).
    """
    if undirected is None:
        undirected = graph.symmetric
    dev = graph.fused.device
    start = start.to(device=dev, dtype=torch.int32)
    b = start.shape[0]
    sentinel = graph.num_nodes
    alpha_np = max(1.0, 1.0 / q)  # bound over non-return candidates
    excess = 1.0 / p - alpha_np
    use_atom = excess > 0.0
    use_cdf = "cdf" in graph.channels
    trial_fn = _trial_fn(graph, p, q, extend, alpha_np, use_cdf)

    start_rows = graph.gather_rows(start)
    alive0 = graph.rows_nbr(start_rows)[:, 0] != sentinel
    d0 = draws(FIRST, graph.rows_degree(start_rows)).trials()[0]
    first, w_first = rejection.propose(
        graph, d0.u_small, start_rows, use_cdf, d0.kk, d0.u_self
    )
    col1 = torch.where(alive0, first, start)
    eff = torch.where(alive0, walk_length + 1, 1).to(torch.int32)
    if walk_length == 1:
        walks1 = torch.stack([start, col1], dim=1)
        return (walks1, eff, 0) if return_rounds else (walks1, eff)

    col1_rows = graph.gather_rows(col1)
    has1 = graph.rows_nbr(col1_rows)[:, 0] != sentinel
    eff = torch.where(alive0 & ~has1, 2, eff).to(torch.int32)
    alive = alive0 & has1

    # column L + 1 takes the writes of lanes that did not advance
    buf = torch.zeros((b, walk_length + 2), dtype=torch.int32, device=dev)
    buf[:, 0] = start
    buf[:, 1] = col1

    if use_atom:
        if undirected:
            wp = w_first  # w(col1 -> start) == the first proposal's weight
        else:
            _, wp = rejection.membership(graph, start, col1_rows)
        theta = _theta_from(graph, wp, col1_rows, excess, alpha_np)
    else:
        theta = wp = None

    cur, prev, cur_rows = col1, start, col1_rows
    step = torch.full((b,), 2, dtype=torch.int32, device=dev)
    round_cap = walk_length * round_cap_factor + 64
    unroll = max(int(unroll), 1)

    def pending_count() -> int:
        n = (alive & (step <= walk_length)).sum(dtype=torch.int32)
        if graph.loop_sync is not None:  # every rank runs the same rounds
            n = graph.loop_sync(n)
        with trace.sync("pecanpy.walk.pending_read"):
            return int(n)

    t = 0
    pending = pending_count()
    while pending > 0 and t < round_cap:
        with trace.span("pecanpy.walk.hub_block"):
            for _ in range(unroll):
                needs = alive & (step <= walk_length)
                x, ok, wx = trial_fn(
                    draws(t, graph.rows_degree(cur_rows)), prev, cur, cur_rows, theta,
                    wp,
                )
                t += 1
                adv = needs & ok
                col = torch.where(adv, step, walk_length + 1)
                buf.scatter_(1, col[:, None].long(), x[:, None])
                prev = torch.where(adv, cur, prev)
                cur = torch.where(adv, x, cur)
                cur_rows = graph.gather_rows(cur)  # the one row gather per round
                step = step + adv.to(torch.int32)
                # arrival check: stepping onto a node with no out-edges ends
                # the walk, recording the effective length
                has = graph.rows_nbr(cur_rows)[:, 0] != sentinel
                died = adv & ~has & (step <= walk_length)
                eff = torch.where(died, step, eff)
                alive = alive & ~died
                if use_atom:
                    if undirected:
                        wp_n = wx  # w(new cur -> new prev) == w(cur -> x)
                    else:
                        _, wp_n = rejection.membership(graph, prev, cur_rows)
                    theta_n = _theta_from(graph, wp_n, cur_rows, excess, alpha_np)
                    theta = torch.where(adv, theta_n, theta)
                    wp = torch.where(adv, wp_n, wp)
            pending = pending_count()  # the one host read per block

    trace.count("walk.hub_rounds", t)
    trace.count("walk.hub_lane_rounds", t * b)
    # every column a lane wrote in the rounds (from column 2), read only
    # when asked: ``step`` is each lane's next column
    trace.count("walk.hub_steps", step)
    trace.count("walk.hub_steps", -2 * b)
    # resting emission: columns past the effective length (or past a
    # round-cap truncation) repeat the walker's final node
    cols = torch.arange(walk_length + 1, dtype=torch.int32, device=dev)[None, :]
    fill_from = torch.minimum(eff, step)[:, None]
    walks = torch.where(cols < fill_from, buf[:, : walk_length + 1], cur[:, None])
    if return_rounds:
        return walks, eff, t
    return walks, eff
