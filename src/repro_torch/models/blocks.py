"""Transformer blocks of the dense family: the attention sub-block, the MLP
sub-block and their per-layer init.

Counterpart of the dense parts of ``repro/models/blocks.py``.  The MoE, SSM
and hybrid blocks, the sliding window and the prefill/decode paths are not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.policy import requested_policy
from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, rms_norm, rope


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


def apply_attn(p, cfg, x, *, positions, use_window: bool = False):
    if use_window and cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window attention is not ported to repro_torch yet (ROADMAP "
            "queue A: the serving slice)"
        )
    q, k, v = _qkv(p, cfg, x, positions)
    if uses_flash_kernel(cfg):
        out = ops.flash_attention(
            q, k, v, causal=cfg.causal,
            block_q=min(cfg.block_q, 128), block_k=min(cfg.block_k, 128),
        )
    else:
        out = flash_attention(
            q, k, v, causal=cfg.causal, prefix_len=cfg.prefix_len,
            block_q=cfg.block_q, block_k=cfg.block_k, parallel_q=cfg.seq_par_attention,
        )
    b, l, _ = x.shape
    return out.reshape(b, l, -1) @ p["wo"]


def init_block(generator: torch.Generator, cfg, *, device=None) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only dense blocks are ported to repro_torch "
            "(ROADMAP queue A: the MoE, SSM, hybrid, VLM and audio families)"
        )
    zeros = dict(dtype=cfg.pdtype, device=device)
    return {
        "norm_attn": torch.zeros((cfg.d_model,), **zeros),
        "attn": init_attn(generator, cfg, device=device),
        "norm_ffn": torch.zeros((cfg.d_model,), **zeros),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation, cfg.pdtype,
                        device=device),
    }


def apply_block(p, cfg, h, *, positions, use_window: bool = False):
    """Forward of one dense block (no cache).  A dense block has no router,
    so the JAX package's MoE auxiliary terms are not returned."""
    h = h + apply_attn(p["attn"], cfg, rms_norm(h, p["norm_attn"]), positions=positions,
                       use_window=use_window)
    x = rms_norm(h, p["norm_ffn"])
    return h + apply_mlp(p["mlp"], x, cfg.activation)
