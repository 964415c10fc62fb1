"""Memory-efficient attention in plain PyTorch (flash-style online softmax).

Counterparts of ``repro/models/attention.py``:

* ``flash_attention`` (``:51``): full / causal / prefix-LM masked attention,
  doubly blocked (a loop over query blocks, an inner loop over key blocks),
  so the score tensor never grows beyond ``(B, Hkv, G, BQ, BK)``.  It runs
  under autograd, so the LoRA workload trains through it;
* ``sliding_window_attention`` (``:129``): causal attention over the last
  ``window`` keys, a static ``window + BQ`` key slice per query block of the
  key stream left-padded by ``window``: O(L * window);
* ``decode_attention`` (``:180``): one query token against a KV cache in
  the linear or the ring layout.

``decode_attention_parts`` is ``decode_attention`` on one rank's block of a
cache's slots (a cache split over a grid's ``model`` axis by slot, as
``launch.sharding.cache_pspec`` splits a cache whose kv heads do not divide
the axis): this rank's softmax statistics, which ``merge_decode_parts``
combines over the axis by a log-sum-exp.

The reference computes the last two outside any Pallas kernel, so they are
plain torch here, in f32 with the reference's masking (no
``F.scaled_dot_product_attention``, whose masking and accumulation differ).
GQA: q heads grouped over kv heads.  Shapes: q (B, Lq, Hq, D), k, v (B, Lk,
Hkv, D), G = Hq // Hkv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _block_attend(qb, kb, vb, mask, scale):
    """One (BQ x BK) tile. qb: (B,BQ,Hk,G,D); kb/vb: (B,BK,Hk,D);
    mask: broadcastable to (B,Hk,G,BQ,BK).  Returns (m, l, o) stats."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float())
    s = s * scale + torch.where(mask, 0.0, NEG_INF)
    m = torch.amax(s, dim=-1)  # (B,Hk,G,BQ)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
    return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0, q_offset: int = 0,
                    block_q: int = 512, block_k: int = 512, parallel_q: bool = False):
    """Blocked attention with online softmax.  ``prefix_len`` makes the first
    ``prefix_len`` key positions visible to every query (prefix-LM / VLM);
    ``q_offset`` shifts the query positions of the causal mask; padded keys
    are masked.  ``parallel_q`` (the JAX package's sequence-parallel lever,
    a hint to XLA's partitioner) has no effect: the port has no partitioner."""
    del parallel_q
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    g = hq // hkv
    block_q = min(block_q, lq)
    block_k = min(block_k, lk)
    nq, nk = -(-lq // block_q), -(-lk // block_k)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qs = q.reshape(b, lq, hkv, g, d)
    outs = []
    for iq in range(nq):
        q0 = iq * block_q
        qb = qs[:, q0 : q0 + block_q]
        if qb.shape[1] < block_q:  # zero-pad the last block, as the reference pads
            qb = torch.cat([qb, qb.new_zeros((b, block_q - qb.shape[1], hkv, g, d))], dim=1)
        qpos = q_offset + q0 + torch.arange(block_q, device=dev)
        m = torch.full((b, hkv, g, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, block_q), dtype=torch.float32, device=dev)
        o = torch.zeros((b, hkv, g, block_q, d), dtype=torch.float32, device=dev)
        for ik in range(nk):
            k0 = ik * block_k
            kb, vb = k[:, k0 : k0 + block_k], v[:, k0 : k0 + block_k]
            if kb.shape[1] < block_k:
                pad = kb.new_zeros((b, block_k - kb.shape[1], hkv, d))
                kb, vb = torch.cat([kb, pad], dim=1), torch.cat([vb, pad], dim=1)
            kpos = k0 + torch.arange(block_k, device=dev)
            mask = (kpos < lk)[None, :]
            if causal:
                allowed = kpos[None, :] <= qpos[:, None]
                if prefix_len:
                    allowed = allowed | (kpos[None, :] < prefix_len)
                mask = mask & allowed
            m2, l2, o2 = _block_attend(qb, kb, vb, mask[None, None, None], scale)
            m, l, o = _merge(m, l, o, m2, l2, o2)
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])  # (B,Hk,G,BQ,D)
    # (nq, b, hk, g, bq, d) -> (b, nq, bq, hk, g, d) -> (b, l, hq, d)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, nq * block_q, hq, d)
    return out[:, :lq].to(q.dtype)


def sliding_window_attention(q, k, v, *, window: int, q_offset: int = 0, block_q: int = 512):
    """Causal attention restricted to the last ``window`` keys -- O(L*window).

    KV is left-padded by ``window`` (and right-padded by the query padding),
    so each query block reads the slice ``[iq*BQ, iq*BQ + window + BQ)`` of
    the padded stream; a key is seen when ``kpos <= qpos``, ``qpos - kpos <
    window`` and ``kpos >= 0``."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    g = hq // hkv
    block_q = min(block_q, lq)
    pq = (-lq) % block_q
    nq = (lq + pq) // block_q
    qs = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(b, nq, block_q, hkv, g, d)
    kp = F.pad(k, (0, 0, 0, 0, window, pq))
    vp = F.pad(v, (0, 0, 0, 0, window, pq))
    span = window + block_q
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    outs = []
    for iq in range(nq):
        start = iq * block_q
        kb, vb = kp[:, start:start + span], vp[:, start:start + span]
        qpos = q_offset + iq * block_q + torch.arange(block_q, device=dev)
        kpos = q_offset + iq * block_q - window + torch.arange(span, device=dev)
        allowed = ((kpos[None, :] <= qpos[:, None])
                   & (qpos[:, None] - kpos[None, :] < window)
                   & (kpos[None, :] >= 0))
        _, l, o = _block_attend(qs[:, iq], kb, vb, allowed[None, None, None], scale)
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])  # (B,Hk,G,BQ,D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, nq * block_q, hq, d)
    return out[:, :lq].to(q.dtype)


def _valid_slots(slot, cache_len, slots: int, window: int, ring: bool):
    """(B, S) mask of the slots ``slot`` (global numbers) a decode step
    reads in a cache of ``slots`` slots holding ``cache_len`` positions."""
    if ring:
        return slot[None, :] < torch.clamp(cache_len, max=slots)[:, None]
    valid = slot[None, :] < cache_len[:, None]
    if window:
        valid = valid & (slot[None, :] >= cache_len[:, None] - window)
    return valid


def decode_attention(q1, k_cache, v_cache, cache_len, *, window: int = 0, ring: bool = False):
    """Single-step attention.  q1: (B, Hq, D); caches: (B, S, Hkv, D);
    ``cache_len`` (B,) int, the positions the cache holds after this step.

    Linear layout: slot ``< cache_len`` is valid, and ``>= cache_len -
    window`` too when ``window > 0``.  ``ring=True``: the cache is a ring
    buffer (slot ``pos % S``), every slot ``< min(cache_len, S)`` valid,
    since every live slot lies within the window by construction.  It reads
    nothing from the host."""
    b, s, hkv, d = k_cache.shape
    hq = q1.shape[1]
    qs = q1.reshape(b, hkv, hq // hkv, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bhgd,bshd->bhgs", qs.float(), k_cache.float()) * scale
    valid = _valid_slots(torch.arange(s, device=k_cache.device), cache_len, s, window, ring)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, d).to(q1.dtype)


def decode_attention_parts(q1, k_block, v_block, cache_len, *, slot0, slots: int,
                           window: int = 0, ring: bool = False):
    """``decode_attention`` on a block of a cache's slots: ``k_block`` and
    ``v_block`` (B, S_r, Hkv, D) hold the slots ``slot0 .. slot0 + S_r - 1``
    of a cache of ``slots`` slots, and the masks read those global numbers
    (the linear layout, with or without a window, and the ring).  Returns
    this block's f32 (max (B, Hkv, G), sum (B, Hkv, G), unnormalised output
    (B, Hkv, G, D)) for ``merge_decode_parts``.  A masked slot weighs
    exactly 0, so a block whose slots are all masked gives max ``NEG_INF``,
    sum 0 and output 0.  It reads nothing from the host."""
    b, s, hkv, d = k_block.shape
    hq = q1.shape[1]
    qs = q1.reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qs.float(), k_block.float()) * (1.0 / (d ** 0.5))
    valid = _valid_slots(slot0 + torch.arange(s, device=k_block.device), cache_len, slots,
                         window, ring)[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = torch.amax(scores, dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bhgs,bshd->bhgd", p, v_block.float())


def merge_decode_parts(m, l, o, mesh, axes, dtype):
    """The attention output (B, Hq, D) in ``dtype`` from every rank's
    ``decode_attention_parts`` over ``axes`` of ``mesh``: the global max
    (one ``pmax``), then each rank's sum and output rescaled to it and
    summed in one packed ``psum``.  A block with no valid slot has weight
    ``exp(NEG_INF - max) = 0``."""
    b, hkv, g, d = o.shape
    w = torch.exp(m - mesh.pmax(m, axes))
    total = mesh.psum(torch.cat([(l * w)[..., None], o * w[..., None]], dim=-1), axes)
    out = total[..., 1:] / torch.clamp(total[..., :1], min=1e-30)
    return out.reshape(b, hkv * g, d).to(dtype)
