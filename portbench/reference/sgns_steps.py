"""Plain reference of the port's batched SGNS trainer, step by step.

What the trainer computes, written out pair by pair in float32 (the port
computes it with banded matmuls, a shared negative pool and its own
appliers): gensim's skip-gram with negative sampling over the walk tokens
(subsampling with gensim's keep probability, reduced windows, unigram^0.75
negatives, a linear learning-rate decay), in chunk-steps of
``batch_walks`` walks whose updates land as capped means: a row's summed
gradient is scaled by min(count, cap) / count, cap = 2 * window, with the
centre updates and the negative updates of W_out as separate groups.

The random numbers are derived from the seed as the trainer derives them
(``SeedSequence([seed, 1, step])`` for a chunk-step, a generator seeded
with the seed for the initial W_in), so the reference follows the same
trajectory. It reads the port's walks, which it judges separately
(``walklaw``), and derives every other input itself: token counts, keep
probabilities, the negative table, learning rates, initial tables.
"""
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    dim: int = 128
    window: int = 10
    negative: int = 5
    alpha: float = 0.025
    min_alpha: float = 0.0001
    sample: float = 1e-3
    neg_pool: int = 32768
    table_size: int = 1 << 22

    @property
    def cap(self) -> float:
        return 2.0 * self.window


def batch_walks(h: Hyper, num_nodes: int, walk_cols: int) -> int:
    """Walks per chunk-step: enough for max(2048, N) window pairs."""
    target = max(2048, num_nodes)
    per_walk = max(walk_cols * min(h.window, walk_cols), 1)
    return int(np.clip(-(-target // per_walk), 1, 4096))


def token_counts(chunks, num_nodes: int, device) -> torch.Tensor:
    """Occurrences of each node in the walks' valid prefixes (float64)."""
    counts = torch.zeros(num_nodes, dtype=torch.float64, device=device)
    for walks, eff in chunks:
        walks, eff = walks.to(device).long(), eff.to(device).long()
        valid = torch.arange(walks.shape[1], device=device)[None] < eff[:, None]
        counts += torch.bincount(walks[valid], minlength=num_nodes).double()
    return counts


def keep_probs(counts: torch.Tensor, sample: float) -> torch.Tensor:
    """gensim's keep probability (sqrt(c / t) + 1) * t / c, t = sample * total."""
    c = counts.to(torch.float32)
    t = sample * c.sum()
    c = torch.clamp(c, min=1.0)
    return torch.clamp((torch.sqrt(c / t) + 1.0) * t / c, 0.0, 1.0)


def negative_table(counts: np.ndarray, size: int, seed: int) -> np.ndarray:
    """word2vec's unigram^0.75 table, shuffled under the seed."""
    p = np.asarray(counts, dtype=np.float64) ** 0.75
    p = p / max(p.sum(), 1e-30)
    grid = (np.arange(size) + 0.5) / size
    table = np.minimum(np.searchsorted(np.cumsum(p), grid), counts.size - 1).astype(np.int32)
    np.random.default_rng(seed).shuffle(table)
    return table


def initial_tables(seed: int, num_nodes: int, dim: int, stored_dtype, device):
    """(w_in, w_out) float32: w_in ~ U(-0.5/dim, 0.5/dim) drawn by a
    generator seeded with ``seed`` and stored in ``stored_dtype``, w_out 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    bound = 0.5 / dim
    w_in = torch.empty((num_nodes, dim), device=device).uniform_(-bound, bound, generator=gen)
    return w_in.to(stored_dtype).to(torch.float32), torch.zeros_like(w_in)


@dataclasses.dataclass
class Draws:
    u_sub: torch.Tensor
    eff_win: torch.Tensor
    neg_slots: torch.Tensor
    pool_off: int


def step_draws(seed: int, g: int, wb: int, t: int, h: Hyper, device) -> Draws:
    """The random numbers of global chunk-step ``g``."""
    ss = np.random.SeedSequence([int(seed), 1, int(g)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1)[0]))
    host = np.random.default_rng(ss)
    u_sub = torch.rand((wb, t), generator=gen, device=device)
    eff_win = h.window - torch.randint(0, h.window, (wb, t), generator=gen, device=device)
    if wb * t * h.negative > h.neg_pool:
        slots = torch.randint(0, h.table_size, (h.neg_pool,), generator=gen, device=device)
        off = int(host.integers(0, h.neg_pool))
    else:
        slots = torch.randint(0, h.table_size, (wb, t, h.negative), generator=gen, device=device)
        off = 0
    return Draws(u_sub, eff_win, slots, off)


def _stripe_bases(k_neg: int, bt: int, m: int):
    """Pool offsets of the K negative stripes, distinct mod m."""
    if k_neg >= m:
        return [(k * bt + k) % m for k in range(k_neg)]
    bases, used = [], set()
    for k in range(k_neg):
        b = (k * bt + k) % m
        while b in used:
            b = (b + 1) % m
        bases.append(b)
        used.add(b)
    return bases


def negatives(neg_table: torch.Tensor, d: Draws, bt: int, h: Hyper) -> torch.Tensor:
    """[bt, K] negative node of each (token, slot): from the pool, token n
    of stripe k takes slot (bases[k] + n) mod M of the rotated pool."""
    if bt * h.negative > h.neg_pool:
        pool = torch.roll(neg_table[d.neg_slots.long()], -d.pool_off).long()
        bases = torch.tensor(_stripe_bases(h.negative, bt, h.neg_pool), device=pool.device)
        slot = (bases[None, :] + torch.arange(bt, device=pool.device)[:, None]) % h.neg_pool
        return pool[slot]
    return neg_table[d.neg_slots.long()].reshape(bt, h.negative).long()


def _capped_update(table, rows, sums, cnts, lr, cap):
    """Per row: lr * (summed rows) * min(count, cap) / count."""
    n, dim = table.shape
    s = torch.zeros((n, dim), dtype=torch.float32, device=table.device).index_add_(0, rows, sums)
    c = torch.zeros(n, dtype=torch.float32, device=table.device).index_add_(0, rows, cnts)
    return lr * s * (torch.clamp(c, max=cap) / torch.clamp(c, min=1e-9))[:, None]


def sgns_step(w_in, w_out, walks, eff, keep_prob, neg_table, lr, d: Draws, h: Hyper,
              update: bool = True) -> float:
    """One chunk-step from (w_in, w_out) float32, pair by pair; updates the
    tables in place when ``update``. Returns the step's loss, the mean
    over its (centre, context) pairs of -log s(u.v) - sum_k log s(-u_k.v)."""
    dev = w_in.device
    walks, eff = walks.to(dev).long(), eff.to(dev).long()
    wb, t = walks.shape
    pos = torch.arange(t, device=dev)
    keep = (pos[None] < eff[:, None]) & (d.u_sub < keep_prob[walks])
    order = torch.argsort(torch.where(keep, pos, pos + t), dim=1)
    comp = walks.gather(1, order)  # kept tokens first, in walk order
    m = keep.sum(1)
    offs = torch.tensor([o for o in range(-h.window, h.window + 1) if o != 0], device=dev)
    b_i, i_i, o_i = torch.meshgrid(torch.arange(wb, device=dev), pos, offs, indexing="ij")
    j_i = i_i + o_i
    ok = ((o_i.abs() <= d.eff_win[b_i, i_i]) & (i_i < m[b_i]) & (j_i >= 0) & (j_i < m[b_i]))
    b_p, i_p, j_p = b_i[ok], i_i[ok], j_i[ok]
    tok_c, tok_x = b_p * t + i_p, b_p * t + j_p  # flat token index of centre, context
    flat = comp.reshape(-1)
    centre, ctx = flat[tok_c], flat[tok_x]
    v, u = w_in[ctx], w_out[centre]
    s = (u * v).sum(1)
    g = torch.sigmoid(s) - 1.0
    bt = wb * t
    negs = negatives(neg_table, d, bt, h)  # [bt, K]
    clean = (negs[tok_x] != centre[:, None]).to(torch.float32)  # [P, K]
    pair_cnt = torch.zeros((bt, h.negative), device=dev).index_add_(0, tok_x, clean)
    v_tok = w_in[flat]
    u_neg = w_out[negs]  # [bt, K, dim]
    nl = torch.einsum("nd,nkd->nk", v_tok, u_neg)
    gn = torch.sigmoid(nl)
    pairs = max(int(s.numel()), 1)
    loss = float(-(torch.nn.functional.logsigmoid(s).sum()
                   + (pair_cnt * torch.nn.functional.logsigmoid(-nl)).sum()) / pairs)
    if not update:
        return loss
    a = gn * pair_cnt  # [bt, K]
    dv = torch.zeros((bt, w_in.shape[1]), device=dev).index_add_(0, tok_x, g[:, None] * u)
    dv += torch.einsum("nk,nkd->nd", a, u_neg)
    cnt_v = torch.bincount(tok_x, minlength=bt).to(torch.float32)
    du = torch.zeros_like(dv).index_add_(0, tok_c, g[:, None] * v)
    cnt_u = torch.bincount(tok_c, minlength=bt).to(torch.float32)
    du_neg = (a[:, :, None] * v_tok[:, None, :]).reshape(-1, w_in.shape[1])
    d_in = _capped_update(w_in, flat, dv, cnt_v, lr, h.cap)
    d_out = (_capped_update(w_out, flat, du, cnt_u, lr, h.cap)
             + _capped_update(w_out, negs.reshape(-1), du_neg, pair_cnt.reshape(-1), lr, h.cap))
    w_in -= d_in
    w_out -= d_out
    return loss


def chunk_lrs(h: Hyper, eff_host: np.ndarray, chunk: int, steps: int, total_tokens: float):
    """Learning rates of the first ``steps`` chunk-steps of the first
    buffer: alpha decayed linearly in the tokens trained before each."""
    sums = np.add.reduceat(eff_host.astype(np.float64), np.arange(0, eff_host.size, chunk))
    starts = np.concatenate([[0.0], np.cumsum(sums)[:-1]])[:steps]
    return np.maximum(h.min_alpha, h.alpha - (h.alpha - h.min_alpha)
                      * (starts / max(total_tokens, 1.0))).astype(np.float32)


def fp8_store(x: torch.Tensor) -> torch.Tensor:
    """x stored as float8 e4m3 with a per-tensor scale (amax to 448)."""
    amax = float(x.abs().max())
    if amax == 0.0:
        return x.clone()
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def follow(chunks, num_nodes: int, seed: int, h: Hyper, steps: int, stored_dtype, device,
           store=None):
    """The first ``steps`` chunk-steps of a run, from the seed and the
    walks. Returns (tables after each of 0..steps chunk-steps as host
    tensors [(w_in, w_out)], losses [steps]). ``store`` rounds the tables
    after the start and every step (the control's lower precision)."""
    counts = token_counts(chunks, num_nodes, device)
    keep = keep_probs(counts, h.sample)
    table = torch.from_numpy(negative_table(counts.cpu().numpy(), h.table_size, seed)).to(device)
    total = float(counts.sum())
    walks0, eff0 = chunks[0]
    wb = min(batch_walks(h, num_nodes, walks0.shape[1]), walks0.shape[0])
    lrs = chunk_lrs(h, eff0.cpu().numpy(), wb, steps, total)
    w_in, w_out = initial_tables(seed, num_nodes, h.dim, stored_dtype, device)
    if store is not None:
        w_in, w_out = store(w_in), store(w_out)
    states, losses = [(w_in.to("cpu", copy=True), w_out.to("cpu", copy=True))], []
    for k in range(steps):
        sl = slice(k * wb, (k + 1) * wb)
        d = step_draws(seed, k, wb, walks0.shape[1], h, device)
        losses.append(sgns_step(w_in, w_out, walks0[sl], eff0[sl], keep, table,
                                float(lrs[k]), d, h))
        if store is not None:
            w_in.copy_(store(w_in))
            w_out.copy_(store(w_out))
        states.append((w_in.to("cpu", copy=True), w_out.to("cpu", copy=True)))
    return states, losses, dict(keep=keep, table=table, lrs=lrs, wb=wb)


def state_losses(states, chunks, seed, h: Hyper, aux, device):
    """The loss of each chunk-step k evaluated at ``states[k]`` (another
    side's tables before that step), with the reference's inputs."""
    walks0, eff0 = chunks[0]
    wb = aux["wb"]
    out = []
    for k in range(len(states) - 1):
        w_in, w_out = (x.to(device, torch.float32) for x in states[k])
        sl = slice(k * wb, (k + 1) * wb)
        d = step_draws(seed, k, wb, walks0.shape[1], h, device)
        out.append(sgns_step(w_in, w_out, walks0[sl], eff0[sl], aux["keep"], aux["table"],
                             float(aux["lrs"][k]), d, h, update=False))
    return out
