"""Transformer blocks of the dense and MoE families: the attention
sub-block (forward, prefill into a KV cache, one decode step), the MLP or
MoE sub-block and their per-layer init and cache.

Counterpart of ``repro/models/blocks.py`` without the SSM and hybrid blocks
(ROADMAP queue A).

Attention routes.  The forward takes the sliding window under
``use_window`` when the config sets one, else the hand-written flash kernel
(``ops.flash_attention``) when ``uses_flash_kernel(cfg)`` holds, else the
plain blocked attention.  The linear prefill takes the flash kernel under
the same test, where the reference always runs its blocked attention
(``repro/models/blocks.py:127``): in prefill ``Lq == Lk`` and there is no
prefix, so the kernel's top-left causal mask is the reference's (ROADMAP
C.2); the route changes, not the function, and with
``use_pallas_attention=False`` prefill follows the reference op for op.
The windowed prefill and the decode step are plain torch, as in the
reference.

KV caches.  Linear: slot = position, the prompt's keys padded to
``cache_size``.  Ring (windowed prefill): slot = ``pos % cache_size``;
prefill keeps the last ``cache_size`` keys, rolled so that slot i holds the
position whose ``pos % cache_size == i``.  ``decode_attn`` writes the new
key and value into the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.policy import requested_policy
from repro_torch.models.attention import (
    decode_attention,
    flash_attention,
    sliding_window_attention,
)
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, rms_norm, rope
from repro_torch.models.moe import apply_moe, init_moe


def init_attn(generator: torch.Generator, cfg, *, device=None) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kw = dict(device=device)
    return {
        "wq": dense_init(generator, (d, hq * hd), cfg.pdtype, **kw),
        "wk": dense_init(generator, (d, hkv * hd), cfg.pdtype, **kw),
        "wv": dense_init(generator, (d, hkv * hd), cfg.pdtype, **kw),
        "wo": dense_init(generator, (hq * hd, d), cfg.pdtype, **kw),
    }


def _qkv(p, cfg, x, positions):
    b, l, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, l, hq, hd)
    k = (x @ p["wk"]).reshape(b, l, hkv, hd)
    v = (x @ p["wv"]).reshape(b, l, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def uses_flash_kernel(cfg) -> bool:
    """The route of ``repro/models/blocks.py:88``: the kernel when the
    config asks for it, there is no prefix-LM span, and the process-wide
    policy does not veto kernels (``$REPRO_TORCH_KERNELS=torch``)."""
    return bool(cfg.use_pallas_attention and not cfg.prefix_len
                and requested_policy() != "torch")


def _attention(cfg, q, k, v):
    """Full-context attention: the flash kernel under ``uses_flash_kernel``,
    else the plain blocked attention."""
    if uses_flash_kernel(cfg):
        return ops.flash_attention(q, k, v, causal=cfg.causal,
                                   block_q=min(cfg.block_q, 128), block_k=min(cfg.block_k, 128))
    return flash_attention(q, k, v, causal=cfg.causal, prefix_len=cfg.prefix_len,
                           block_q=cfg.block_q, block_k=cfg.block_k,
                           parallel_q=cfg.seq_par_attention)


def apply_attn(p, cfg, x, *, positions, use_window: bool = False):
    q, k, v = _qkv(p, cfg, x, positions)
    if use_window and cfg.sliding_window:
        out = sliding_window_attention(q, k, v, window=cfg.sliding_window, block_q=cfg.block_q)
    else:
        out = _attention(cfg, q, k, v)
    b, l, _ = x.shape
    return out.reshape(b, l, -1) @ p["wo"]


def prefill_attn(p, cfg, x, *, positions, cache_size: int, use_window: bool):
    """Attention over the prompt, and its KV cache (linear or ring layout)."""
    q, k, v = _qkv(p, cfg, x, positions)
    b, l = x.shape[:2]
    if use_window and cfg.sliding_window:
        out = sliding_window_attention(q, k, v, window=cfg.sliding_window, block_q=cfg.block_q)
        w = cache_size
        if l >= w:  # the last w keys, rolled so that slot i holds pos % w == i
            k_cache = torch.roll(k[:, -w:], l % w, dims=1)
            v_cache = torch.roll(v[:, -w:], l % w, dims=1)
        else:
            k_cache = F.pad(k, (0, 0, 0, 0, 0, w - l))
            v_cache = F.pad(v, (0, 0, 0, 0, 0, w - l))
    else:
        if cache_size < l:
            raise ValueError(f"linear cache of {cache_size} slots cannot hold a prompt of {l}")
        out = _attention(cfg, q, k, v)
        k_cache = F.pad(k, (0, 0, 0, 0, 0, cache_size - l))
        v_cache = F.pad(v, (0, 0, 0, 0, 0, cache_size - l))
    return out.reshape(b, l, -1) @ p["wo"], (k_cache, v_cache)


def decode_attn(p, cfg, x1, cache_kv, pos, *, ring: bool):
    """x1: (B, d); cache_kv = (k_cache, v_cache), each (B, S, Hkv, D); pos
    (B,).  Writes the step's key and value into the cache in place, at slot
    ``pos % S`` (ring) or ``pos`` (linear, which needs ``pos < S``); the
    linear layout masks the config's window, the ring its valid slots."""
    b = x1.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x1 @ p["wq"]).reshape(b, 1, hq, hd)
    k = (x1 @ p["wk"]).reshape(b, 1, hkv, hd)
    v = (x1 @ p["wv"]).reshape(b, hkv, hd)
    q = rope(q, pos[:, None], cfg.rope_theta)[:, 0]
    k = rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    k_cache, v_cache = cache_kv
    slot = torch.remainder(pos, k_cache.shape[1]) if ring else pos
    bidx = torch.arange(b, device=x1.device)
    k_cache.index_put_((bidx, slot.long()), k.to(k_cache.dtype))
    v_cache.index_put_((bidx, slot.long()), v.to(v_cache.dtype))
    out = decode_attention(q, k_cache, v_cache, pos + 1,
                           window=0 if ring else cfg.sliding_window, ring=ring)
    return out.reshape(b, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# full block (attention + MLP or MoE)
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg, *, device=None) -> dict:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: only dense and MoE blocks are ported to repro_torch "
            "(ROADMAP A.5: the SSM, hybrid, VLM and audio families)"
        )
    zeros = dict(dtype=cfg.pdtype, device=device)
    p = {
        "norm_attn": torch.zeros((cfg.d_model,), **zeros),
        "attn": init_attn(generator, cfg, device=device),
        "norm_ffn": torch.zeros((cfg.d_model,), **zeros),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff, cfg.num_experts,
                            cfg.activation, cfg.pdtype, device=device)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation, cfg.pdtype,
                            device=device)
    return p


def _moe(p, cfg, x):
    return apply_moe(p["moe"], x, num_experts=cfg.num_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor, activation=cfg.activation)


def apply_block(p, cfg, h, *, positions, use_window: bool = False):
    """Forward of one block (no cache) -> (h, (lb_loss, z_loss)); a dense
    block has no router and returns (h, None) (the reference's zeros)."""
    h = h + apply_attn(p["attn"], cfg, rms_norm(h, p["norm_attn"]), positions=positions,
                       use_window=use_window)
    x = rms_norm(h, p["norm_ffn"])
    if cfg.family == "moe":
        y, aux = _moe(p, cfg, x)
        return h + y, aux
    return h + apply_mlp(p["mlp"], x, cfg.activation), None


def init_block_cache(cfg, batch: int, cache_size: int, dtype, *, device=None):
    """One layer's empty (k, v) cache, each (B, S, Hkv, D)."""
    shape = (batch, cache_size, cfg.num_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def prefill_block(p, cfg, h, *, positions, cache_size: int, use_window: bool):
    a, cache = prefill_attn(p["attn"], cfg, rms_norm(h, p["norm_attn"]), positions=positions,
                            cache_size=cache_size, use_window=use_window)
    h = h + a
    x = rms_norm(h, p["norm_ffn"])
    if cfg.family == "moe":
        return h + _moe(p, cfg, x)[0], cache
    return h + apply_mlp(p["mlp"], x, cfg.activation), cache


def decode_block(p, cfg, h1, cache_kv, pos, *, ring: bool):
    """One token through one block, h1 (B, d); the layer's cache is written
    in place."""
    h1 = h1 + decode_attn(p["attn"], cfg, rms_norm(h1, p["norm_attn"]), cache_kv, pos,
                          ring=ring)
    x = rms_norm(h1, p["norm_ffn"])
    if cfg.family == "moe":
        return h1 + _moe(p, cfg, x[:, None, :])[0][:, 0]
    return h1 + apply_mlp(p["mlp"], x, cfg.activation)
