"""Batched sampling over padded weight rows: inverse CDF and alias tables.

Counterpart of ``pecanpy_tpu/ops/sampling.py``. The draws come in as
arguments (``u`` of shape [B, 1] in [0, 1) for the inverse CDF; ``kk`` and
``u`` of shape [B] for an alias draw), so tests can feed the JAX key
tree's numbers and compare choices exactly.
"""
import torch


def pick_int_columns(values: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """values[b, choice[b]] for int32 rows (exact: no float round trip)."""
    return values.gather(1, choice.long()[:, None])[:, 0]


def sample_from_cdf(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Sample one column per row from inclusive CDF rows.

    Args:
        u: [B, 1] uniforms in [0, 1).
        cdf: [B, D] non-decreasing rows; padded slots hold the total.

    Returns:
        [B] int64 column choices.
    """
    total = cdf[:, -1:]
    choice = (cdf < u * total).sum(dim=-1)
    return torch.clamp(choice, max=cdf.shape[1] - 1)


def categorical_rows(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One column per row proportionally to ``weights`` (padded slots 0).

    The reference's ``searchsorted(cumsum(probs), rand())`` with the
    normalization folded into the draw. Rows summing to 0 return 0
    (callers mask dead walkers out separately).
    """
    return sample_from_cdf(u, torch.cumsum(weights, dim=-1))


def _blocked_row_sum(w: torch.Tensor, block: int = 32) -> torch.Tensor:
    """[R] row sums of ``w`` [R, D] added in the order the JAX function's
    jitted ``jnp.sum`` adds them on the CPU: left to right within windows
    of 32 columns (the row centered in its zero padding), then the
    windows' sums the same way. ``Tensor.sum`` adds in another order, which
    moves a row's total by an ulp now and then, and the alias loop's
    ``q + q - 1`` carries that into q several ulps deep (up to 1,408 ulps
    on a small q). No order is more exact than another; this one exists so
    that the tables can be held to the JAX function's at one ulp."""
    r, d = w.shape
    if d <= block:
        total = torch.zeros(r, dtype=w.dtype, device=w.device)
        for c in range(d):
            total = total + w[:, c]
        return total
    pad = -d % block
    wp = torch.nn.functional.pad(w, (pad // 2, pad - pad // 2))
    return _blocked_row_sum(_blocked_row_sum(wp.reshape(-1, block)).reshape(r, -1), block)


def alias_build(weights: torch.Tensor, degrees: torch.Tensor):
    """Vose alias tables for a batch of padded weight rows.

    Args:
        weights: [R, D] non-negative float32 weights, 0 at padded slots.
        degrees: [R] int true row lengths.

    Returns:
        (alias_j [R, D] int32, alias_q [R, D] float32). Padded slots get
        ``q = 1, j = self``.

    ``pecanpy_tpu/ops/sampling.py:_alias_setup_row`` vectorized over the
    rows: scale each row's probabilities by its length, stack the small
    (< 1) and large entries, then pair the top small with the top large
    entry D times; a row whose stacks have drained stays as it is. The
    steps run in the JAX function's f32 order, the row sum's too
    (``_blocked_row_sum``), so the tables match the jitted JAX function's
    on the CPU to the bit.
    """
    r, d = weights.shape
    dev = weights.device
    idx = torch.arange(d, device=dev)
    rows = torch.arange(r, device=dev)
    k = degrees.to(torch.int64)
    valid = idx[None, :] < k[:, None]
    total = _blocked_row_sum(weights)[:, None]
    kf = k.to(weights.dtype)[:, None]
    q = torch.where(valid, weights * kf / torch.clamp(total, min=1e-30), 1.0)
    j = idx.expand(r, d).clone()

    def stack(mask):
        # positions of the entries under ``mask``, packed from slot 0
        rank = torch.cumsum(mask, dim=-1) - 1
        out = torch.full((r, d + 1), -1, dtype=torch.int64, device=dev)
        out.scatter_(1, torch.where(mask, rank, d), idx.expand(r, d).clone())
        return out[:, :d], mask.sum(dim=-1)

    small_stack, n_small = stack((q < 1.0) & valid)
    large_stack, n_large = stack((q >= 1.0) & valid)
    for _ in range(d):
        act = (n_small > 0) & (n_large > 0)
        if not bool(act.any()):
            break
        a = rows[act]
        ns, nl = n_small[act] - 1, n_large[act] - 1
        small, large = small_stack[a, ns], large_stack[a, nl]
        new_q = q[a, large] + q[a, small] - 1.0
        j[a, small] = large
        q[a, large] = new_q
        # the retired large entry goes back on one of the stacks
        goes_small = new_q < 1.0
        small_stack[a[goes_small], ns[goes_small]] = large[goes_small]
        large_stack[a[~goes_small], nl[~goes_small]] = large[~goes_small]
        n_small[a] = torch.where(goes_small, ns + 1, ns)
        n_large[a] = torch.where(goes_small, nl, nl + 1)
    return j.to(torch.int32), q.to(torch.float32)


def alias_draw(
    alias_j: torch.Tensor,
    alias_q: torch.Tensor,
    row: torch.Tensor,
    kk: torch.Tensor,
    u: torch.Tensor,
) -> torch.Tensor:
    """Draw one column per walker from per-row alias tables.

    Args:
        alias_j: [R, D] int32 alias indices.
        alias_q: [R, D] float32 acceptance thresholds.
        row: [B] int table row per walker.
        kk: [B] int slot per walker, uniform in ``[0, max(degree, 1))``
            (``rejection.slot_offsets`` makes it from a uniform).
        u: [B] float32 uniforms in [0, 1), the accept coin.

    Returns:
        [B] int32 column choices: ``kk`` if ``u < q[row, kk]``, else
        ``j[row, kk]`` (reference draw, ``pecanpy.py:668-677``).
    """
    flat = row.to(torch.int64) * alias_j.shape[1] + kk.to(torch.int64)
    q_val = alias_q.reshape(-1)[flat]
    j_val = alias_j.reshape(-1)[flat]
    return torch.where(u < q_val, kk.to(torch.int32), j_val).to(torch.int32)
