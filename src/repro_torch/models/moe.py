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

Under a grid (``tp``, a ``layers.ModelAxis``).  Expert parallelism: with
the expert dim of ``gate``, ``up`` and ``down`` split over ``model``
(``repro/launch/sharding.py:62``), every model rank computes the same
routing from the replicated router, each (token, choice)'s global slot
among all E experts, fills ``(B, E / m, cap + 1, d)`` with the choices of
its own experts (the others go to the drop bin), runs them, and gathers
each token's k outputs, those of experts held elsewhere reading 0.  The
k-weighted sum is summed over ``model`` (``reduce_from``); the tokens and
the gates enter through ``copy_to``, so their gradients, which each rank
computes for its own experts only, are summed before they reach the router.
Under FSDP the batch's rows split over the data axes: the load-balance
loss ``e * sum(me * ce)`` is a product of two means over all the rows, so
the sums of the router probabilities, of the top-1 one-hots and of the
squared log-sum-exps (the z-loss), and the token count, are summed over the
data axes (one ``reduce_from``) before the means are taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import copy_to, reduce_from
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
              capacity_factor: float, activation: str, tp=None):
    """x: (B, L, d) -> (y, (load_balance_loss, z_loss)).  Reads nothing
    from the host.  ``tp``: the grid's placement (see the module
    docstring)."""
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

    experts, xin = idx, x
    split = tp is not None and tp.has("moe/up")
    if split:  # this rank's experts; the others' choices go to the drop bin
        mesh = tp.mesh
        e_local = p["up"].shape[0]
        experts = idx - mesh.index("model") * e_local
        mine = (experts >= 0) & (experts < e_local)
        experts = torch.where(mine, experts, 0)
        slot = torch.where(mine, slot, cap)
        xin, gates = copy_to(x, mesh, "model"), copy_to(gates, mesh, "model")
    buf = xin.new_zeros((b, p["up"].shape[0], cap + 1, d))
    bidx = torch.arange(b, device=x.device)[:, None, None]
    buf.index_put_((bidx, experts, slot), xin[:, :, None, :].expand(b, l, k, d),
                   accumulate=True)
    y_exp = F.pad(_expert_ffn(p, buf[:, :, :cap], activation), (0, 0, 0, 1))  # drop bin: 0
    y_tok = y_exp[bidx, experts, slot]  # (B,L,k,d)
    y = torch.sum(y_tok * gates[..., None].to(y_tok.dtype), dim=2)
    if split:
        y = reduce_from(y, mesh, "model")

    top1 = F.one_hot(idx[..., 0], e).float()
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    if tp is not None and tp.batch_axes:  # means over the rows of every data rank
        count = torch.full((1,), float(b * l), device=x.device)
        sums = reduce_from(torch.cat([probs.sum(dim=(0, 1)), top1.sum(dim=(0, 1)),
                                      lse2.sum()[None], count]), tp.mesh, tp.batch_axes)
        n = sums[-1]
        lb = e * torch.sum((sums[:e] / n) * (sums[e:2 * e] / n))
        return y.to(x.dtype), (lb, sums[2 * e] / n)
    me = torch.mean(probs, dim=(0, 1))  # mean router prob per expert
    ce = torch.mean(torch.sum(top1, dim=1) / l, dim=0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(lse2)
    return y.to(x.dtype), (lb, z)
