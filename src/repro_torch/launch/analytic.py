"""Analytic FLOP and byte model per (arch x input shape): the port's copy of
``repro/launch/analytic.py``, the same arithmetic on the port's
``ModelConfig`` and ``INPUT_SHAPES``.

Conventions:
  * N_matmul      -- parameters in matmuls (embeddings excluded, the LM head
                     included); N_active for MoE counts top_k experts.
  * MODEL_FLOPS   -- 6·N·D (train) / 2·N·D (inference) with D = tokens
                     processed by the step.
  * analytic_flops -- adds the attention O(ctx) terms, the local steps and
                     remat's three passes of the federated round (the
                     screening is left out).
"""

from __future__ import annotations

from repro_torch.launch.specs import INPUT_SHAPES, LOCAL_STEPS


def _param_counts(cfg) -> dict:
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.hd
    mlp_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    per_layer_attn = (d * (cfg.num_heads * hd) * 2 + d * (cfg.num_kv_heads * hd) * 2
                      if cfg.num_heads else 0)
    out = {"embed": V * d, "head": d * V}
    if cfg.family in ("ssm", "hybrid"):
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per_layer = d * (2 * di + 2 * n + h) + di * d
        out["layers_total"] = cfg.num_layers * per_layer
        out["layers_active"] = out["layers_total"]
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            shared = per_layer_attn + mlp_mats * d * ff
            out["shared"] = shared
            out["layers_total"] += shared
            out["layers_active"] += shared * (cfg.num_layers // cfg.shared_attn_every)
    elif cfg.family == "moe":
        expert = mlp_mats * d * ff
        per_layer_total = per_layer_attn + cfg.num_experts * expert
        per_layer_active = per_layer_attn + cfg.top_k * expert
        out["layers_total"] = cfg.num_layers * per_layer_total
        out["layers_active"] = cfg.num_layers * per_layer_active
    else:
        per_layer = per_layer_attn + mlp_mats * d * ff
        out["layers_total"] = cfg.num_layers * per_layer
        out["layers_active"] = out["layers_total"]
    if cfg.frontend != "none":
        out["frontend"] = cfg.frontend_dim * d
    return out


def n_params_total(cfg) -> float:
    c = _param_counts(cfg)
    return c["layers_total"] + c["embed"] + c["head"] + c.get("frontend", 0)


def n_matmul_active(cfg) -> float:
    c = _param_counts(cfg)
    return c["layers_active"] + c["head"] + c.get("frontend", 0)


def _attn_flops_per_token(cfg, ctx: float) -> float:
    """score + value matmul flops per token per attention layer."""
    if not cfg.num_heads:
        return 0.0
    return 4.0 * ctx * cfg.num_heads * cfg.hd


def _ssm_flops_per_token(cfg) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    h, p, n, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    intra = 2.0 * q * n + 2.0 * q * h * p      # C·B^T scores + L-weighted apply
    inter = 4.0 * n * h * p                    # state update + readout
    return intra + inter


def analytic_report(cfg, shape_name: str, mesh_rows: int) -> dict:
    info = INPUT_SHAPES[shape_name]
    seq, gb, kind = info["seq"], info["global_batch"], info["kind"]
    n_act = n_matmul_active(cfg)
    n_tot = n_params_total(cfg)

    attn_layers = (
        cfg.num_layers if cfg.family in ("dense", "moe", "vlm", "audio")
        else (cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0)
    )
    ssm_layers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0

    if kind == "train":
        K = mesh_rows if cfg.fed_mode == "vmap" else cfg.fed_clients
        b = max(gb // K, 1) if cfg.fed_mode == "vmap" else gb
        tokens = K * LOCAL_STEPS * b * seq
        ctx = seq / 2
        per_tok = 2.0 * n_act + attn_layers * _attn_flops_per_token(cfg, ctx) \
            + ssm_layers * _ssm_flops_per_token(cfg)
        mult = 3.0  # fwd + bwd
        if cfg.fed_mode == "remat":
            mult *= 3.0  # aggregation recompute passes
        flops = mult * per_tok * tokens
        model_flops = 6.0 * n_act * tokens * (3.0 if cfg.fed_mode == "remat" else 1.0)
        bytes_params = (2 if cfg.fed_mode != "vmap" else K) * n_tot * 2.0
    elif kind == "prefill":
        tokens = gb * seq
        ctx = seq / 2
        per_tok = 2.0 * n_act + attn_layers * _attn_flops_per_token(cfg, ctx) \
            + ssm_layers * _ssm_flops_per_token(cfg)
        flops = per_tok * tokens
        model_flops = 2.0 * n_act * tokens
        bytes_params = n_tot * 2.0
    else:  # decode / long_decode
        tokens = gb
        ctx = (min(seq, cfg.sliding_window) if (kind == "long_decode" and cfg.sliding_window)
               else seq)
        if cfg.family == "ssm":
            ctx = 0
        per_tok = 2.0 * n_act + attn_layers * _attn_flops_per_token(cfg, ctx) \
            + ssm_layers * _ssm_flops_per_token(cfg)
        flops = per_tok * tokens
        model_flops = 2.0 * n_act * tokens
        bytes_params = n_tot * 2.0  # whole model read once per decode step

    return {
        "n_params_total": float(n_tot),
        "n_matmul_active": float(n_act),
        "tokens": float(tokens),
        "analytic_flops": float(flops),
        "model_flops_6nd": float(model_flops),
        "param_read_bytes": float(bytes_params),
    }
