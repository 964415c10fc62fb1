"""Plain PyTorch twins of the hand-written kernels.

Each twin computes the same function as the JAX package's ``kernels/ops.py``
wrapper of the corresponding Pallas kernel, EPS rules included.  The ops
wrappers take the twin for CPU tensors; ``chip_smoke.py`` holds each CUDA
kernel against its twin on the card.  ``flash_attention_tc_ref``,
``flash_attention_3xtf32_ref``, ``gram_3xtf32_ref`` and
``trimmed_mean_rowsum_ref`` are twins of a kernel's own arithmetic (the
bf16/f16 attention kernel rounds p before p.v; the f32 attention kernel and
the Gram kernel multiply TF32 halves on the tensor cores; the trimmed-mean
kernel adds in row order); only the tests and ``chip_smoke.py`` use them.
The module imports nothing else of the port, as
``repro/kernels/afa_screen.py`` keeps its own mirrors of the screening
statistics.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def weighted_sum_ref(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(K, d), (K,) -> (d,) weighted sum in f32 (``ops.weighted_sum``)."""
    return weights.float() @ updates.float()


def cosine_sim_ref(updates: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    """(K, d), (d,) -> (K,) cosine similarities (``ops.cosine_sim``): the
    EPS clamp is on the SQUARED norms."""
    u = updates.float()
    w = agg.float()
    un = torch.sqrt(torch.clamp((u * u).sum(dim=1), min=EPS))
    wn = torch.sqrt(torch.clamp((w * w).sum(), min=EPS))
    return (u @ w) / (un * wn)


def gram_ref(updates: torch.Tensor) -> torch.Tensor:
    """(K, d) -> (K, K) Gram matrix in f32 (``ops.gram``)."""
    u = updates.float()
    return u @ u.T


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 explicit mantissa bits, ties away from zero; an f32
    tensor whose low 13 bits are zero.  Inf and NaN pass through."""
    x = x.float().contiguous()
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def tf32_split(x: torch.Tensor):
    """``x = hi + lo`` to 2^-22 relative: ``hi = tf32(x)``, ``lo = tf32(x - hi)``
    (``x - hi`` is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def gram_3xtf32_ref(updates: torch.Tensor) -> torch.Tensor:
    """(K, d) -> (K, K): the Gram kernel's own arithmetic on the card
    (``gram_tf32x3_kernel``), u_i u_j ~ lo_i hi_j + hi_i lo_j + hi_i hi_j with
    the bit-exact TF32 split of ``tf32_split``.  The products are exact and
    are summed here in float64, then cast to f32: the kernel differs from this
    twin only by its f32 sums."""
    hi, lo = (t.double() for t in tf32_split(updates))
    return (lo @ hi.T + hi @ lo.T + hi @ hi.T).float()


def _live_order_stats(updates: torch.Tensor, mask):
    """Each column of ``updates`` sorted with the dead rows pushed to +inf,
    and the live count ``m`` (a 0-d tensor).  The sort is stable, so equal
    values keep client-index order: position r holds the row of rank r under
    the kernels' compare-count rank with ties broken by client index."""
    u = updates.float()
    if mask is None:
        mask = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    live = mask.bool()
    srt = torch.sort(torch.where(live[:, None], u, torch.inf), dim=0, stable=True).values
    return srt, live.sum()


def coord_median_ref(updates: torch.Tensor, mask=None) -> torch.Tensor:
    """(K, d) [+ (K,) mask] -> (d,) coordinate-wise median
    (``ops.coord_median``): the mean of the live order statistics
    ``(m-1)//2`` and ``m//2``, and 0 where no row is live.  Pure selection, so
    it equals the compare-count kernel bit for bit."""
    srt, m = _live_order_stats(updates, mask)
    lo = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)
    med = 0.5 * (srt[lo] + srt[hi])
    return torch.where(m > 0, med, 0.0)


def trimmed_mean_ref(updates: torch.Tensor, mask, *, trim: int) -> torch.Tensor:
    """(K, d), (K,) mask -> (d,) coordinate-wise trimmed mean
    (``ops.trimmed_mean``): the live values of rank ``trim <= r < m - trim``
    over ``max(m - 2 trim, 1)``; the masked mean over ``max(m, 1)`` when
    ``m <= 2 trim``."""
    srt, m = _live_order_stats(updates, mask)
    pos = torch.arange(srt.shape[0], device=srt.device)[:, None]
    keep = (pos >= trim) & (pos < m - trim)
    trimmed = torch.where(keep, srt, 0.0).sum(dim=0) / torch.clamp(m - 2 * trim, min=1)
    live = mask.bool()[:, None]
    mean = torch.where(live, updates.float(), 0.0).sum(dim=0) / torch.clamp(m, min=1)
    return torch.where(m > 2 * trim, trimmed, mean)


def trimmed_mean_rowsum_ref(updates: torch.Tensor, mask, *, trim: int) -> torch.Tensor:
    """(K, d), (K,) mask -> (d,): the trimmed-mean kernel's own arithmetic.
    The kept values (the live values of rank ``trim <= r < m - trim``, or
    every live value when ``m <= 2 trim``) added in ascending row order,
    starting from +0.0, in f32; then one f32 division by ``m - 2 trim`` (or
    ``max(m, 1)``).  The ranks come from a stable sort by value (-0.0 and
    +0.0 equal, ties in row order), then by liveness, so a dead row never
    takes a live row's place."""
    u = updates.float()
    K = u.shape[0]
    live = mask.bool()
    m = int(live.sum())
    if m <= 2 * trim:
        keep = live[:, None].expand_as(u)
        cnt = max(m, 1)
    else:
        by_value = torch.sort(u, dim=0, stable=True).indices
        by_live = torch.sort((~live)[by_value].int(), dim=0, stable=True).indices
        order = by_value.gather(0, by_live)  # row of rank r, the live rows first
        pos = torch.arange(K, device=u.device)[:, None].expand_as(u)
        keep = torch.zeros_like(u, dtype=torch.bool).scatter_(
            0, order, (pos >= trim) & (pos < m - trim))
        cnt = m - 2 * trim
    acc = torch.zeros(u.shape[1:], dtype=torch.float32, device=u.device)
    for k in range(K):
        acc = torch.where(keep[k], acc + u[k], acc)
    # tensor by tensor: a division by a Python scalar may become a product
    # with its reciprocal
    return acc / torch.full_like(acc, float(cnt))


def _masked_mean(x, mask):
    m = mask.sum()
    mean = torch.where(mask, x, 0.0).sum() / torch.clamp(m, min=1)
    return torch.where(m > 0, mean, 0.0)


def _masked_std(x, mask, ddof):
    m = mask.sum()
    mu = _masked_mean(x, mask)
    var = torch.where(mask, (x - mu) ** 2, 0.0).sum() / torch.clamp(m - ddof, min=1)
    return torch.sqrt(torch.clamp(var, min=0.0))


def masked_median_cc(x, mask):
    """Masked median by compare-count rank selection (ties broken by client
    index), as the fused screening kernel computes it: the same two order
    statistics a sort picks, so the value equals the sort-based median."""
    K = x.shape[0]
    m = mask.sum()
    live = mask[None, :]
    lt = (x[None, :] < x[:, None]) & live
    idx = torch.arange(K, device=x.device)
    eq = (x[None, :] == x[:, None]) & (idx[:, None] > idx[None, :]) & live
    rank = (lt.int() + eq.int()).sum(dim=1)
    lo = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)
    v_lo = torch.where(mask & (rank == lo), x, 0.0).sum()
    v_hi = torch.where(mask & (rank == hi), x, 0.0).sum()
    return torch.where(m > 0, 0.5 * (v_lo + v_hi), 0.0)


def afa_screen_ref(updates, pn, mask0, *, xi0: float, delta_xi: float,
                   max_rounds: int, ddof: int = 0, gram=None):
    """Algorithm 1 on the Gram matrix (``ops.afa_screen``): returns
    ``(aggregate (d,), good_mask (K,) bool, rounds () int32, sims (K,))``.
    ``gram`` is the (K, K) matrix to screen with, ``u @ u.T`` in f32 unless
    given (``gram_3xtf32_ref(updates)`` for the kernel's own arithmetic)."""
    u = updates.float()
    pn = pn.float()
    gram = u @ u.T if gram is None else gram.float()
    row_norms = torch.sqrt((u * u).sum(dim=1))
    K = u.shape[0]

    def weights(m):
        c = torch.where(m, pn, 0.0)
        return c / torch.clamp(c.sum(), min=EPS)

    def sims(c):
        gc = gram @ c
        agg_norm = torch.sqrt(torch.clamp(c @ gc, min=EPS))
        return gc / (torch.clamp(row_norms, min=EPS) * agg_norm)

    def mark_bad(s, m, xi):
        mu_hat = _masked_mean(s, m)
        mu_bar = masked_median_cc(s, m)
        sigma = _masked_std(s, m, ddof)
        low_tail = m & (s < mu_bar - xi * sigma)
        high_tail = m & (s > mu_bar + xi * sigma)
        bad = torch.where(mu_hat < mu_bar, low_tail, high_tail)
        keep_floor = (m & ~bad).sum() >= 2
        return bad & keep_floor

    mask = mask0.bool()
    s = (sims(weights(mask)) if max_rounds == 0
         else torch.zeros((K,), dtype=torch.float32, device=u.device))
    xi = torch.tensor(xi0, dtype=torch.float32, device=u.device)
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        s = sims(weights(mask))
        bad = mark_bad(s, mask, xi)
        mask = mask & ~bad
        xi = xi + delta_xi
        changed = bool(bad.any())
        rounds += 1
    agg = weights(mask) @ u
    return agg, mask, torch.tensor(rounds, dtype=torch.int32, device=u.device), s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """(B, Lq, Hq, D), (B, Lk, Hkv, D) x2 -> (B, Lq, Hq, D): exact softmax in
    f32 with the TPU kernel's mask (``ops.flash_attention``), cast to q's
    dtype.  The causal mask is ``kpos <= qpos`` aligned top-left, as in
    ``repro/kernels/flash_attn.py``; the JAX package's own oracle aligns it
    bottom-right, which agrees only when Lq == Lk.  A masked score is -1e30."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    g = hq // hkv
    qs = q.float().reshape(b, lq, hkv, g, d)
    s = torch.einsum("blhgd,bmhd->bhglm", qs, k.float()) * (1.0 / d ** 0.5)
    if causal:
        mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhglm,bmhd->blhgd", p, v.float())
    return o.reshape(b, lq, hq, d).to(q.dtype)


def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, block_k: int = 64) -> torch.Tensor:
    """(B, Lq, Hq, D), (B, Lk, Hkv, D) x2 -> (B, Lq, Hq, D): the tensor-core
    kernel's arithmetic (bf16/f16 route of ``ops.flash_attention``).

    Key tiles of ``block_k`` (the kernel's, ``ops.ATTN_TC_BLOCK_K``) go
    through the TPU kernel's online softmax in f32, with log2(e) folded into
    the scale as the kernel does; p is rounded to q's dtype before p.v, and l
    is summed from the unrounded f32 p.  On f32 inputs the rounding is a no-op
    and this is ``flash_attention_ref`` up to summation order.  The mask is
    the kernel's (top-left causal, -1e30); the output is acc / max(l, 1e-30)
    cast to q's dtype."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    g = hq // hkv
    scale_log2 = (1.0 / d ** 0.5) * 1.4426950408889634
    qs = q.float().reshape(b, lq, hkv, g, d)
    kf, vf = k.float(), v.float()
    neg = torch.tensor(-1e30, device=q.device)
    m = torch.full((b, hkv, g, lq), -1e30, device=q.device)
    l = torch.zeros((b, hkv, g, lq), device=q.device)
    acc = torch.zeros((b, hkv, g, lq, d), device=q.device)
    qpos = torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lk, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("blhgd,bmhd->bhglm", qs, kb) * scale_log2
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhglm,bmhd->bhgld", p.to(q.dtype).float(), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d).to(q.dtype)


def flash_attention_3xtf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, block_k: int = 64,
                               terms: int = 3) -> torch.Tensor:
    """(B, Lq, Hq, D), (B, Lk, Hkv, D) x2 f32 -> (B, Lq, Hq, D) f32: the f32
    kernel's arithmetic on the card (``flash_attn_tf32x3_kernel``).

    Both products are 3xTF32: each operand splits as ``tf32_split`` does and
    a b ~ lo hi' + hi lo' + hi hi'.  The products are exact; they are summed
    here in float64 over each key tile of ``block_k`` (the kernel's,
    ``ops.ATTN_TC_BLOCK_K``) and rounded to f32, so the kernel differs from
    this twin only by its f32 sums inside a tile.  Around them the TPU
    kernel's online softmax in f32: the unscaled scores masked to -1e30
    (top-left causal), m the running max, p = 2^(s c - m c) with
    c = log2(e) / sqrt(D) and one rounding, as the kernel's FFMA before ex2,
    l = l alpha + rowsum(p), acc = acc alpha + pv; the output is
    acc / max(l, 1e-30).  ``terms`` = 2 drops the lo hi' product and 1 keeps
    hi hi' alone (1xTF32): the faults a check against this twin must see."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    g = hq // hkv
    # the kernel's scale_log2: 1/sqrt(D) and log2(e) as f32, their product in f32
    c = float(torch.tensor(1.0 / d ** 0.5) * torch.tensor(1.4426950408889634))

    def dot(eq, x, y):
        xh, xl = (t.double() for t in tf32_split(x))
        yh, yl = (t.double() for t in tf32_split(y))
        out = torch.einsum(eq, xh, yh)
        if terms >= 2:
            out = out + torch.einsum(eq, xh, yl)
        if terms >= 3:
            out = out + torch.einsum(eq, xl, yh)
        return out.float()

    qs = q.float().reshape(b, lq, hkv, g, d)
    kf, vf = k.float(), v.float()
    neg = torch.tensor(-1e30, device=q.device)
    m = torch.full((b, hkv, g, lq), -1e30, device=q.device)
    l = torch.zeros((b, hkv, g, lq), device=q.device)
    acc = torch.zeros((b, hkv, g, lq, d), device=q.device)
    qpos = torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lk, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = dot("blhgd,bmhd->bhglm", qs, kb)
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * c)
        mc = (m_new * c).double()
        p = torch.exp2((s.double() * c - mc[..., None]).float())
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + dot("bhglm,bmhd->bhgld", p, vb)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d)
