"""Blocks of every family: the attention sub-block (forward, prefill into a
KV cache, one decode step) with its MLP or MoE sub-block, and the Mamba-2
block of the SSM and hybrid families; their per-layer init and cache.

Counterpart of ``repro/models/blocks.py``.

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

Under a grid (``layers.ModelAxis``) a block's leaves pass through
``ModelAxis.use`` first (FSDP's gathers over the data axes).  Over a
``model`` axis of more than one rank the forward's attention is
tensor-parallel: ``wq``, ``wk`` and ``wv`` hold this rank's out-features,
``wo`` its in-features, and the partial products of ``wo`` are summed over
the axis.  Where the split falls on whole heads with the GQA groups kept
together (``num_kv_heads % model == 0``), attention runs on the local
heads.  Where it cuts a head (smollm-135m's 9 q and 3 kv heads over 2
ranks), q, k and v are gathered whole, every rank attends on every head,
and ``wo`` takes this rank's features of the output.  On that path the
forward takes the reference's mesh levers (``attn_lever``), where its
``maybe_shard_axis`` would act: ``activation_sharding`` (the reference
repeats kv to every q head and pins the heads to ``model``), where
``model`` divides the q heads (paligemma-3b's 8 over 2 or 4): q stays on
this rank's heads, k and v are gathered whole and repeated to them, and the
output feeds ``wo``'s row block, summed over the axis; else
``seq_par_attention`` (the reference splits the query blocks over
``model``), where ``model`` divides the query blocks of the plain blocked
route (``block_q = L / model``): each rank attends with its block of them
(``q_offset``, the causal and prefix masks kept) against the whole k and v,
and the rows are gathered over ``model`` before ``wo``.  Each rank then
does 1/m of the attention's products.  The gathers of q, k and v
reduce-scatter their gradients there, since each rank uses them for its
own heads or rows; elsewhere a lever changes nothing, bit for bit.  The
flash-kernel route ignores ``seq_par_attention``, as the reference's does.
The prefill and the decode step take no lever.  An MoE
block's experts split over ``model`` (expert parallelism,
``models/moe.py``).  Serving follows the same two paths: on whole heads
the prefill runs ``_attention`` (the flash kernel) on this rank's heads and
the cache holds its kv heads; where a head is cut, every rank attends on
every head, keeps its block of the cache's slots (``cache_pspec``), and a
decode step writes its key and value on the rank that holds the slot and
merges the ranks' softmax statistics over ``model``
(``attention.decode_attention_parts``, ``merge_decode_parts``).  The paths
serve every family with attention: hubert-xlarge's 16 whole heads
(non-causal) run the flash kernel on each rank's heads, paligemma-3b's one
kv head takes the cut-head path with its cache split by slot and its
prefix-LM mask on the plain blocked attention, and a hybrid model's shared
block its own placement (``models/model.py``).  A Mamba-2 block computes
on its blocks as ``models/ssm.py`` sets out.

Caches.  An SSM or hybrid layer's is ``{"state", "conv"}``
(``models/ssm.py``), an attention layer's ``(k, v)``.  Linear: slot =
position, the prompt's keys padded to ``cache_size``.  Ring (windowed
prefill): slot = ``pos % cache_size``; prefill keeps the last
``cache_size`` keys, rolled so that slot i holds the position whose ``pos %
cache_size == i``.  ``decode_attn`` writes the new
key and value into the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.policy import requested_policy
from repro_torch.models.attention import (
    decode_attention,
    decode_attention_parts,
    flash_attention,
    merge_decode_parts,
    sliding_window_attention,
)
from repro_torch.launch.mesh import copy_to, gather_dim, gather_from, reduce_from
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, rms_norm, rope
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.ssm import apply_mamba2, decode_mamba2, init_mamba2, init_ssm_cache
from repro_torch.utils.regions import ATTENTION, region

_SSM = ("ssm", "hybrid")


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


def _attend(cfg, q, k, v, use_window: bool):
    if use_window and cfg.sliding_window:
        return sliding_window_attention(q, k, v, window=cfg.sliding_window, block_q=cfg.block_q)
    return _attention(cfg, q, k, v)


def attn_lever(cfg, tp, length: int, use_window: bool = False) -> str | None:
    """The mesh lever the forward's attention takes on ``tp``'s ``model``
    axis of m > 1 ranks, where the split cuts a head (``hkv % m != 0``):
    ``"heads"`` under ``activation_sharding`` where ``hq % m == 0`` (each
    rank attends on its q heads, k and v repeated to them); else
    ``"rows"`` under ``seq_par_attention`` on the plain blocked route
    where m divides the query blocks of ``length`` (each rank attends with
    its block of them); else None (every rank attends on every head)."""
    if tp is None or tp.size == 1 or cfg.num_kv_heads % tp.size == 0:
        return None
    m = tp.size
    if (cfg.activation_sharding and cfg.num_heads % m == 0
            and tp.has("attn/wq") and tp.has("attn/wo")):
        return "heads"
    bq = min(cfg.block_q, length)
    if (cfg.seq_par_attention and not uses_flash_kernel(cfg)
            and not (use_window and cfg.sliding_window) and (-(-length // bq)) % m == 0):
        return "rows"
    return None


def apply_attn(p, cfg, x, *, positions, use_window: bool = False, tp=None):
    if tp is not None and tp.size > 1:
        lever = attn_lever(cfg, tp, x.shape[1], use_window)
        if lever == "heads":
            q, k, v, split = _qkv_heads(p, cfg, x, positions, tp)
            with region(ATTENTION):
                out = _attend(cfg, q, k, v, use_window)
            return _out_tp(out.reshape(*x.shape[:2], -1), p, tp, True, split)
        q, k, v, local, split = _qkv_tp(p, cfg, x, positions, tp, summed=lever == "rows")
        with region(ATTENTION):
            if lever == "rows":
                out = _attend_rows(cfg, q, k, v, tp)
            else:
                out = _attend(cfg, q, k, v, use_window)
        return _out_tp(out.reshape(*x.shape[:2], -1), p, tp, local, split)
    q, k, v = _qkv(p, cfg, x, positions)
    with region(ATTENTION):
        out = _attend(cfg, q, k, v, use_window)
    b, l, _ = x.shape
    return out.reshape(b, l, -1) @ p["wo"]


def _attend_rows(cfg, q, k, v, tp):
    """``seq_par_attention``: the plain blocked attention of this rank's
    block of the query blocks (``q_offset`` its first position, the causal
    and prefix masks kept) against the whole k and v; the ranks' rows
    gathered over ``model`` (the gradient, the same on every rank, sliced
    back)."""
    mesh, m = tp.mesh, tp.size
    b, l, hq, hd = q.shape
    bq = min(cfg.block_q, l)
    rows = (-(-l // bq)) // m * bq
    r0 = mesh.index("model") * rows
    mine = flash_attention(q[:, r0:r0 + rows], k, v, causal=cfg.causal,
                           prefix_len=cfg.prefix_len, q_offset=r0, block_q=bq,
                           block_k=cfg.block_k)
    if mine.shape[1] < rows:   # the last rank's block past the sequence
        mine = F.pad(mine, (0, 0, 0, 0, 0, rows - mine.shape[1]))
    return gather_dim(mine, mesh, "model", 1, summed=False)[:, :l]


def _qkv_heads(p, cfg, x, positions, tp):
    """``activation_sharding`` on a cut head: (q on this rank's hq / m
    heads, k and v gathered whole and repeated to them, split).  Every rank
    uses all of k and v for its own heads only, so their gradients are
    summed over ``model``: the gather of the split leaves' columns
    reduce-scatters it, a whole leaf's product enters through
    ``copy_to``."""
    mesh, m = tp.mesh, tp.size
    b, l, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    split = {w: tp.has(f"attn/{w}") for w in ("wq", "wk", "wv", "wo")}
    xin = copy_to(x, mesh, "model")
    q = rope((xin @ p["wq"]).reshape(b, l, hq // m, hd), positions, cfg.rope_theta)
    kv = {w: copy_to(x @ p[w], mesh, "model") for w in ("wk", "wv") if not split[w]}
    cut = [w for w in ("wk", "wv") if split[w]]
    if cut:
        parts = [xin @ p[w] for w in cut]
        full = gather_dim(torch.cat(parts, dim=-1), mesh, "model", -1,
                          summed=True).reshape(b, l, m, -1)
        kv.update((w, t.reshape(b, l, -1)) for w, t in
                  zip(cut, full.split([t.shape[-1] for t in parts], dim=-1)))
    heads = mesh.index("model") * (hq // m) + torch.arange(hq // m, device=x.device)
    group = heads // (hq // hkv)   # each local q head's kv head
    k = rope(kv["wk"].reshape(b, l, hkv, hd), positions, cfg.rope_theta)[:, :, group]
    v = kv["wv"].reshape(b, l, hkv, hd)[:, :, group]
    return q, k, v, split


def _qkv_tp(p, cfg, x, positions, tp, summed: bool = False):
    """``_qkv`` on this rank's blocks of the attention leaves (see the
    module docstring): (q, k, v, local, split), the heads this rank's where
    ``local`` (whole heads, whole GQA groups), else every head gathered
    (those of the leaves the axis splits in one all-reduce); ``split`` says
    which leaves the axis splits.  ``summed``: each rank's use of the
    gathered heads differs (``seq_par_attention``), so their gradients are
    summed over ``model`` (the gather reduce-scatters it, a whole leaf's
    product enters through ``copy_to``)."""
    mesh, m = tp.mesh, tp.size
    b, l, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    split = {w: tp.has(f"attn/{w}") for w in ("wq", "wk", "wv", "wo")}
    xin = copy_to(x, mesh, "model") if split["wq"] or split["wk"] or split["wv"] else x
    local = hkv % m == 0 and all(split.values())
    if local:
        q = (xin @ p["wq"]).reshape(b, l, hq // m, hd)
        k = (xin @ p["wk"]).reshape(b, l, hkv // m, hd)
        v = (xin @ p["wv"]).reshape(b, l, hkv // m, hd)
        return (rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v,
                local, split)

    # the leaves the axis splits gathered in one all-reduce, the others whole
    cut = [w for w in ("wq", "wk", "wv") if split[w]]
    out = {w: copy_to(x @ p[w], mesh, "model") if summed else x @ p[w]
           for w in ("wq", "wk", "wv") if not split[w]}
    if cut:
        parts = torch.cat([xin @ p[w] for w in cut], dim=-1)
        full = gather_dim(parts, mesh, "model", -1, summed=True) if summed else \
            gather_from(parts, mesh, "model")
        full = full.reshape(b, l, m, -1)
        out.update((w, t.reshape(b, l, -1)) for w, t in
                   zip(cut, full.split([p[w].shape[-1] for w in cut], dim=-1)))
    q, k, v = (out[w].reshape(b, l, heads, hd) for w, heads in (("wq", hq), ("wk", hkv),
                                                                   ("wv", hkv)))
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v, local, split


def _out_tp(out, p, tp, local: bool, split: dict):
    """``out @ wo`` of ``_qkv_tp``'s heads, summed over the axis."""
    mesh = tp.mesh
    if local:
        return reduce_from(out @ p["wo"], mesh, "model")
    if not split["wo"]:
        return out @ p["wo"]
    # every rank holds the whole output: wo's features of this rank, the
    # gradient of the others' features summed in from their ranks
    out = copy_to(out, mesh, "model")[..., mesh.block(out.shape[-1], "model")]
    return reduce_from(out @ p["wo"], mesh, "model")


def prefill_attn(p, cfg, x, *, positions, cache_size: int, use_window: bool, tp=None):
    """Attention over the prompt, and its KV cache (linear or ring layout).
    Under ``tp``: this rank's block of the cache, its kv heads (whole-head
    path) or its block of the slots (``cache_pspec``)."""
    grid = tp is not None and tp.size > 1
    if grid:
        q, k, v, local, split = _qkv_tp(p, cfg, x, positions, tp)
    else:
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
    out = out.reshape(b, l, -1)
    if not grid:
        return out @ p["wo"], (k_cache, v_cache)
    if not local and cache_size % tp.size == 0:   # this rank's block of the slots
        block = tp.mesh.block(cache_size, "model")
        k_cache, v_cache = k_cache[:, block].clone(), v_cache[:, block].clone()
    return _out_tp(out, p, tp, local, split), (k_cache, v_cache)


def decode_attn(p, cfg, x1, cache_kv, pos, *, ring: bool, tp=None, slots: int | None = None):
    """x1: (B, d); cache_kv = (k_cache, v_cache), each (B, S, Hkv, D); pos
    (B,).  Writes the step's key and value into the cache in place, at slot
    ``pos % S`` (ring) or ``pos`` (linear, which needs ``pos < S``); the
    linear layout masks the config's window, the ring its valid slots.
    Under ``tp`` the cache is this rank's block: its kv heads, or its
    ``S / model`` slots of a cache of ``slots`` slots, the step's key and
    value written on the rank that holds slot ``pos`` (``pos % slots``)
    alone and the rank's softmax statistics merged over the axis
    (``attention.merge_decode_parts``); nothing is read from the host."""
    b = x1.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grid = tp is not None and tp.size > 1
    if grid:
        q, k, v, local, split = _qkv_tp(p, cfg, x1[:, None], pos[:, None], tp)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
    else:
        q = (x1 @ p["wq"]).reshape(b, 1, hq, hd)
        k = (x1 @ p["wk"]).reshape(b, 1, hkv, hd)
        v = (x1 @ p["wv"]).reshape(b, hkv, hd)
        q = rope(q, pos[:, None], cfg.rope_theta)[:, 0]
        k = rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    k_cache, v_cache = cache_kv
    held = k_cache.shape[1]
    slots = slots or held
    slot = torch.remainder(pos, slots) if ring else pos
    bidx = torch.arange(b, device=x1.device)
    window = 0 if ring else cfg.sliding_window
    if held == slots:
        k_cache.index_put_((bidx, slot.long()), k.to(k_cache.dtype))
        v_cache.index_put_((bidx, slot.long()), v.to(v_cache.dtype))
        out = decode_attention(q, k_cache, v_cache, pos + 1, window=window, ring=ring)
    else:   # this rank's block of the slots: written where it holds slot
        if not grid or local or held * tp.size != slots:
            raise ValueError(f"a cache block of {held} slots is not a model-axis block of "
                             f"{slots} slots")
        slot0 = tp.mesh.index("model") * held
        at = slot - slot0
        inside = ((at >= 0) & (at < held))[:, None, None]
        at = at.clamp(0, held - 1).long()
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache.index_put_((bidx, at), torch.where(inside, new.to(cache.dtype),
                                                     cache[bidx, at]))
        parts = decode_attention_parts(q, k_cache, v_cache, pos + 1, slot0=slot0, slots=slots,
                                       window=window, ring=ring)
        out = merge_decode_parts(*parts, tp.mesh, "model", q.dtype)
    out = out.reshape(b, -1)
    return _out_tp(out, p, tp, local, split) if grid else out @ p["wo"]


# ---------------------------------------------------------------------------
# full block (attention + MLP or MoE, or Mamba-2)
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg, *, device=None) -> dict:
    zeros = dict(dtype=cfg.pdtype, device=device)
    if cfg.family in _SSM:
        return {"norm_ssm": torch.zeros((cfg.d_model,), **zeros),
                "mamba": init_mamba2(generator, cfg, device=device)}
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


def _moe(p, cfg, x, tp=None):
    return apply_moe(p["moe"], x, num_experts=cfg.num_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor, activation=cfg.activation, tp=tp)


def apply_block(p, cfg, h, *, positions, use_window: bool = False, tp=None):
    """Forward of one block (no cache) -> (h, (lb_loss, z_loss)); a block
    with no router returns (h, None) (the reference's zeros).  ``tp``: the
    grid's placement of the block's leaves, ``p`` this rank's blocks of
    them."""
    if tp is not None:
        p = tp.use_tree(p)
    if cfg.family in _SSM:
        return h + apply_mamba2(p["mamba"], cfg, rms_norm(h, p["norm_ssm"]), tp=tp), None
    h = h + apply_attn(p["attn"], cfg, rms_norm(h, p["norm_attn"]), positions=positions,
                       use_window=use_window, tp=tp)
    x = rms_norm(h, p["norm_ffn"])
    if cfg.family == "moe":
        y, aux = _moe(p, cfg, x, tp)
        return h + y, aux
    return h + apply_mlp(p["mlp"], x, cfg.activation, tp), None


def init_block_cache(cfg, batch: int, cache_size: int, dtype, *, device=None):
    """One layer's empty cache: (k, v), each (B, S, Hkv, D), or an SSM
    layer's ``{"state", "conv"}``."""
    if cfg.family in _SSM:
        return init_ssm_cache(cfg, batch, dtype, device=device)
    shape = (batch, cache_size, cfg.num_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def prefill_block(p, cfg, h, *, positions, cache_size: int, use_window: bool, tp=None):
    """The prompt through one block -> (h, the layer's cache); under ``tp``
    on this rank's blocks of the leaves, as ``apply_block``, the cache this
    rank's block (``prefill_attn``)."""
    if tp is not None:
        p = tp.use_tree(p)
    if cfg.family in _SSM:
        out, cache = apply_mamba2(p["mamba"], cfg, rms_norm(h, p["norm_ssm"]),
                                  return_state=True, tp=tp)
        return h + out, cache
    a, cache = prefill_attn(p["attn"], cfg, rms_norm(h, p["norm_attn"]), positions=positions,
                            cache_size=cache_size, use_window=use_window, tp=tp)
    h = h + a
    x = rms_norm(h, p["norm_ffn"])
    if cfg.family == "moe":
        return h + _moe(p, cfg, x, tp)[0], cache
    return h + apply_mlp(p["mlp"], x, cfg.activation, tp), cache


def decode_block(p, cfg, h1, cache, pos, *, ring: bool, tp=None, slots: int | None = None):
    """One token through one block, h1 (B, d); the layer's cache is written
    in place.  ``tp`` and ``slots`` as ``decode_attn``'s."""
    if tp is not None:
        p = tp.use_tree(p)
    if cfg.family in _SSM:
        return h1 + decode_mamba2(p["mamba"], cfg, rms_norm(h1, p["norm_ssm"]), cache, tp)
    h1 = h1 + decode_attn(p["attn"], cfg, rms_norm(h1, p["norm_attn"]), cache, pos,
                          ring=ring, tp=tp, slots=slots)
    x = rms_norm(h1, p["norm_ffn"])
    if cfg.family == "moe":
        return h1 + _moe(p, cfg, x[:, None, :], tp)[0][:, 0]
    return h1 + apply_mlp(p["mlp"], x, cfg.activation, tp)
