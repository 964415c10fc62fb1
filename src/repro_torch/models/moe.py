"""Mixture-of-Experts layer: top-k router + capacity-based scatter dispatch.

Counterpart of ``repro/models/moe.py``.  Dispatch is scatter/gather, not a
one-hot einsum: the tokens go into ``(B, E, cap + 1, d)`` by an
accumulating ``index_put_``, the experts run as batched products over E,
and each token gathers its k outputs back.  Capacity is per batch row
(``cap = max(int(L*k/E*cf), 1)``); a choice past its expert's capacity goes
to the drop bin ``cap``, which the experts never read (Switch/GShard
semantics).  Kept slots are unique, so every kept row of the buffer is its
one token exactly; only the discarded drop bin sums collisions.  The
reference computes all of it outside any Pallas kernel, so it is plain torch
here.  Aux losses: load balance (Shazeer) and the router z-loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             activation: str, dtype, *, device=None) -> dict:
    """The router in f32, the experts in ``dtype``.  ``dense_init``'s fan-in
    is ``shape[0]``, which for the expert weights is E, as in the
    reference (``repro/models/layers.py:59``)."""
    kw = dict(device=device)
    p = {"router": dense_init(generator, (d_model, num_experts), torch.float32, scale=0.02,
                              **kw)}
    if activation in ("swiglu", "geglu"):
        p["gate"] = dense_init(generator, (num_experts, d_model, d_ff), dtype, **kw)
    p["down"] = dense_init(generator, (num_experts, d_ff, d_model), dtype, **kw)
    p["up"] = dense_init(generator, (num_experts, d_model, d_ff), dtype, **kw)
    return p


def _expert_ffn(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (B, E, C, d) -> (B, E, C, d), each expert's FFN on its slots."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu
        h = act(torch.einsum("becd,edf->becf", x, p["gate"])) * torch.einsum(
            "becd,edf->becf", x, p["up"])
    elif activation == "squared_relu":
        h = torch.square(F.relu(torch.einsum("becd,edf->becf", x, p["up"])))
    else:
        h = gelu(torch.einsum("becd,edf->becf", x, p["up"]))
    return torch.einsum("becf,efd->becd", h, p["down"])


def apply_moe(p: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, activation: str):
    """x: (B, L, d) -> (y, (load_balance_loss, z_loss)).  Reads nothing
    from the host."""
    b, l, d = x.shape
    e, k = num_experts, top_k
    cap = max(int(l * k / e * capacity_factor), 1)

    logits = x.float() @ p["router"]  # (B,L,E) f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)  # (B,L,k), descending
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)

    # slot of each (token, choice) within its expert, per batch row: the
    # exclusive count of earlier choices of that expert over the L*k choices
    flat = F.one_hot(idx, e).reshape(b, l * k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    slot = torch.sum(pos_in_expert * flat, dim=-1).reshape(b, l, k)
    slot = torch.where(slot < cap, slot, cap)  # overflow -> the drop bin

    buf = x.new_zeros((b, e, cap + 1, d))
    bidx = torch.arange(b, device=x.device)[:, None, None]
    buf.index_put_((bidx, idx, slot), x[:, :, None, :].expand(b, l, k, d), accumulate=True)
    y_exp = F.pad(_expert_ffn(p, buf[:, :, :cap], activation), (0, 0, 0, 1))  # drop bin: 0
    y_tok = y_exp[bidx, idx, slot]  # (B,L,k,d)
    y = torch.sum(y_tok * gates[..., None].to(y_tok.dtype), dim=2)

    me = torch.mean(probs, dim=(0, 1))  # mean router prob per expert
    ce = torch.mean(torch.sum(F.one_hot(idx[..., 0], e).float(), dim=1) / l, dim=0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y.to(x.dtype), (lb, z)
