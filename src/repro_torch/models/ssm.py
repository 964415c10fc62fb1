"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block in plain torch.

Counterpart of ``repro/models/ssm.py``.  The chunked SSD form turns the
recurrence into per-chunk quadratic products (matmuls) and a short loop
over chunk states.

Shapes (one group, shared by every head):
  x:  (B, L, H, P)    P = ssm_head_dim
  dt: (B, L, H)       softplus-discretised step
  A:  (H,)            negative decay rate per head
  B,C:(B, L, N)       state input and output projections (N = ssm_state)

The intra-chunk terms are laid out (b, nc, h, i, j), so the products with
``x`` are batched matmuls over (b, nc, h) with no permuted copy of a
(q, q) tensor; at most three such f32 tensors are live in a layer (two
under ``torch.no_grad``).

Serving carries a state (B, H, N, P) f32 and the last ``cw - 1`` raw
(pre-conv) rows of ``[x, B, C]``.  ``decode_mamba2`` writes both in place:
the conv window is shifted (its rows move up one, the new row goes last),
so a step reads nothing from the host and a CUDA graph can replay it.

Under a grid (``layers.ModelAxis`` ``tp``, a ``model`` axis of more than
one rank) a layer holds its column block of ``in_proj`` and ``conv_w`` and
its block of ``out_proj``'s d_inner rows; ``A_log``, ``dt_bias``, ``D``,
``conv_b`` and ``gate_norm_w`` are whole.  ``in_proj``'s column block does
not fall on a boundary of z, [x, B, C] and dt (at model 2 mamba2-1.3b's
falls at column 4,256, inside [x, B, C]), so the projection's output is
gathered whole over ``model`` (one all-reduce), ``conv_w`` too (4 rows),
and every rank runs the conv, the SSD on every head and the gated RMSNorm
whole, as one card does; the norm's output enters ``out_proj`` through
``copy_to`` (its gradient summed over the axis), each rank multiplies its
d_inner block by its rows and the partial products are summed
(``reduce_from``): 3 all-reduces a layer forward, 2 backward.

Under the reference's ``activation_sharding`` lever, which pins the SSD's
heads to ``model`` (``repro/models/ssm.py:122``), the forward's SSD runs on
this rank's H / m heads where m divides H (``ssd_heads``): B and C stay
whole, the gated RMSNorm's mean square is summed over the axis, and
``out_proj``'s d_inner rows are the rank's heads, so y is never gathered.  The gathers of the projection and of ``conv_w``
then reduce-scatter their gradients, and the whole leaves a rank uses a
part of enter through ``copy_to``: a rank's SSD work and its (q, q) f32
tensors fall by m, all but the heads' shared C . B products.  The serving
cache is this rank's ``cache_pspec`` block: the state split over N (dim 2
of a layer's (B, H, N, P)), the conv window whole.  The prefill keeps the
N block of the final state; a decode step updates its N block (the update
is elementwise in N, with B's columns of the block) and sums ``y = sum_N
C state`` over the axis: 4 all-reduces a layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import copy_to, gather_dim, gather_from, reduce_from
from repro_torch.launch.sharding import cache_pspec
from repro_torch.models.layers import dense_init
from repro_torch.utils.regions import SSD, region


def init_mamba2(generator: torch.Generator, cfg, *, device=None) -> dict:
    d, di, h, n, cw = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
    d_xbc = di + 2 * n  # the conv runs over [x, B, C]
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, (d, 2 * di + 2 * n + h), cfg.pdtype, device=device),
        "conv_w": dense_init(generator, (cw, d_xbc), cfg.pdtype, scale=0.5, device=device),
        "conv_b": torch.zeros((d_xbc,), dtype=cfg.pdtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "out_proj": dense_init(generator, (di, d), cfg.pdtype, device=device),
        "gate_norm_w": torch.zeros((di,), dtype=cfg.pdtype, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width cw, then SiLU.  xbc: (B, L, D)."""
    cw, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    out = pad[:, 0:l] * w[0]
    for i in range(1, cw):
        out = out + pad[:, i:i + l] * w[i]
    return F.silu(out + b)


def _ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD scan -> (y (B, L, H, P) in x's dtype, final state (B, H,
    N, P) f32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, -1)                      # (b,nc,q,h) or (b,nc,q,1)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    a_cs = torch.cumsum((A * dtc).float(), dim=2)           # within-chunk log-decay (b,nc,q,h)
    a_tot = a_cs[:, :, -1]                                  # (b,nc,h)
    xbar = xc.float() * dtc[..., None]                      # (b,nc,q,h,p)
    xbar_h = xbar.permute(0, 1, 3, 2, 4)                    # (b,nc,h,q,p)
    a_h = a_cs.permute(0, 1, 3, 2)                          # (b,nc,h,q)

    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(a_cs_i - a_cs_j) xbar_j;
    # mask BEFORE exp: the anti-causal entries grow and would overflow, and
    # exp(-inf) = 0 keeps them out of the gradient
    iq = torch.arange(chunk, device=x.device)
    causal = iq[:, None] >= iq[None, :]
    lmat = torch.exp(torch.where(causal, a_h[..., :, None] - a_h[..., None, :], -torch.inf))
    scores = Cc @ Bc.transpose(-1, -2)                      # (b,nc,i,j)
    y = (lmat * scores[:, :, None]) @ xbar_h                # (b,nc,h,i,p)
    del lmat

    # chunk states: S_c = sum_j exp(a_tot - a_cs_j) B_j xbar_j^T  (b,nc,h,n,p)
    w_in = torch.exp(a_tot[:, :, None, :] - a_cs)           # (b,nc,j,h)
    s_c = Bc.transpose(-1, -2)[:, :, None] @ (xbar * w_in[..., None]).permute(0, 1, 3, 2, 4)

    # inter-chunk recurrence: the state entering each chunk
    decay = torch.exp(a_tot)                                # (b,nc,h)
    s = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * decay[:, c, :, None, None] + s_c[:, c]
    s_in = torch.stack(s_in, dim=1)                         # (b,nc,h,n,p)

    # inter-chunk output: y_i += exp(a_cs_i) C_i . S_in
    y = y + torch.exp(a_h)[..., None] * (Cc[:, :, None] @ s_in)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, h, p)
    y = y + D[:, None] * x.float()
    return y[:, :l].to(x.dtype), s


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(proj, [di, di + 2 * n, cfg.ssm_heads], dim=-1)


def _split(tp, leaf: str) -> bool:
    return tp is not None and tp.has(f"mamba/{leaf}")


def _gathered(t, tp, summed: bool):
    """The column blocks ``t`` gathered whole over ``model``; ``summed``:
    each rank uses a part of the whole, so the gradient is summed over the
    axis (a reduce-scatter), else sliced."""
    if summed:
        return gather_dim(t, tp.mesh, "model", -1, summed=True)
    return gather_from(t, tp.mesh, "model")


def _in_proj(p, u, tp, summed: bool = False):
    """``u @ in_proj``, whole: under ``tp`` this rank's columns gathered
    over ``model``."""
    if not _split(tp, "in_proj"):
        return u @ p["in_proj"]
    return _gathered(copy_to(u, tp.mesh, "model") @ p["in_proj"], tp, summed)


def _conv_w(p, tp, summed: bool = False):
    """``conv_w`` whole: under ``tp`` its column blocks gathered."""
    return _gathered(p["conv_w"], tp, summed) if _split(tp, "conv_w") else p["conv_w"]


def ssd_heads(cfg, tp) -> bool:
    """Whether the forward's SSD runs on this rank's heads
    (``activation_sharding`` on a ``model`` axis of m > 1 ranks that
    divides the heads and splits ``out_proj``'s rows: the reference's
    ``maybe_shard_axis(xh, 2)``)."""
    return bool(cfg.activation_sharding and tp is not None and tp.size > 1
                and cfg.ssm_heads % tp.size == 0 and _split(tp, "out_proj"))


def _summed(p, names, mesh) -> dict:
    """The whole leaves ``names`` through ``copy_to`` over ``model`` (each
    rank uses a part of them, so their gradients are summed), those of one
    dtype in one."""
    by_dtype: dict = {}
    for n in names:
        by_dtype.setdefault(p[n].dtype, []).append(n)
    out = {}
    for ns in by_dtype.values():
        parts = copy_to(torch.cat([p[n].reshape(-1) for n in ns]), mesh, "model").split(
            [p[n].numel() for n in ns])
        out.update({n: t.view_as(p[n]) for n, t in zip(ns, parts)})
    return out


def _gated_out(p, y, z, dtype, tp=None, heads: bool = False):
    """The gated RMSNorm of mamba2, then ``out_proj`` (under ``tp`` on this
    rank's d_inner block, summed over ``model``).  ``heads``: y, z and
    ``gate_norm_w`` are already this rank's d_inner block (the SSD on its
    heads), the mean square's sum taken over ``model`` (``reduce_from``
    then ``copy_to``: the sum both ways)."""
    g = y.float() * F.silu(z.float())
    if heads:
        mesh = tp.mesh
        var = copy_to(reduce_from(torch.sum(g * g, dim=-1, keepdim=True), mesh, "model"), mesh,
                      "model") / (g.shape[-1] * mesh.size("model"))
    else:
        var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-6) * (1.0 + p["gate_norm_w"].float())
    if heads:
        return reduce_from(g.to(dtype) @ p["out_proj"], tp.mesh, "model")
    if not _split(tp, "out_proj"):
        return g.to(dtype) @ p["out_proj"]
    g = copy_to(g, tp.mesh, "model")[..., tp.mesh.block(g.shape[-1], "model")]
    return reduce_from(g.to(dtype) @ p["out_proj"], tp.mesh, "model")


def state_split(cfg, tp) -> bool:
    """Whether this rank's serving state holds a block of N (the
    reference's ``cache_pspec`` of a state (L, B, H, N, P) splits N over
    ``model`` where it divides it); raises for the layouts the port does
    not run: the heads split in N's place, or the conv window's rows."""
    if tp is None or tp.size == 1:
        return False
    h, n, pdim, cw = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv_width
    state = cache_pspec((1, 1, h, n, pdim), tp.mesh)
    conv = cache_pspec((1, 1, cw - 1, cfg.d_inner + 2 * n), tp.mesh)
    if state[2] is not None or conv[2] is not None:
        raise ValueError(f"{cfg.name} on a model axis of {tp.size}: the serving cache would "
                         "split the SSM heads or the conv window's rows "
                         f"(state {state}, conv {conv}); the port splits the state's N alone")
    return state[3] is not None


def apply_mamba2(p, cfg, u, *, return_state: bool = False, tp=None):
    """u: (B, L, d_model) -> (B, L, d_model); with ``return_state`` also the
    serving cache ``{"state": (B, H, N, P) f32, "conv": (B, cw - 1, d_inner +
    2N)}`` (under ``tp`` this rank's block: the state's N block).  Under
    ``ssd_heads`` the forward (not the prefill) runs the SSD on this rank's
    heads: the projection and the conv whole, as without the lever, then
    this rank's x and z columns, dt, A and D of its heads with B and C
    whole, and ``out_proj`` on the rank's d_inner rows, which are its
    heads' (no gather of y)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    heads = not return_state and ssd_heads(cfg, tp)
    if heads:   # each rank uses a part of these whole leaves: their gradients summed
        p = dict(p, **_summed(p, ("conv_b", "gate_norm_w", "A_log", "dt_bias", "D"), tp.mesh))
    z, xbc_raw, dt_raw = _split_proj(cfg, _in_proj(p, u, tp, summed=heads))
    xbc = _causal_conv(xbc_raw, _conv_w(p, tp, summed=heads), p["conv_b"])
    x, B, C = torch.split(xbc, [di, n, n], dim=-1)
    if heads:
        cols, mine = tp.mesh.block(di, "model"), tp.mesh.block(h, "model")
        x, z, dt_raw = x[..., cols], z[..., cols], dt_raw[..., mine]
        p = dict(p, gate_norm_w=p["gate_norm_w"][cols],
                 **{k: p[k][mine] for k in ("A_log", "dt_bias", "D")})
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(*x.shape[:2], -1, cfg.ssm_head_dim)
    with region(SSD):
        y, state = _ssd_chunked(xh, dt, A, B, C, p["D"], cfg.ssm_chunk)
    out = _gated_out(p, y.reshape(*u.shape[:2], -1), z, u.dtype, tp, heads)
    if not return_state:
        return out
    if state_split(cfg, tp):   # this rank's block of N
        state = state[:, :, tp.mesh.block(n, "model")].clone()
    # the cache keeps the RAW (pre-conv) xbc tail, as decode_mamba2 reads it
    cw = cfg.ssm_conv_width
    tail = xbc_raw[:, -(cw - 1):]
    tail = F.pad(tail, (0, 0, (cw - 1) - tail.shape[1], 0))
    return out, {"state": state, "conv": tail}


def init_ssm_cache(cfg, batch: int, dtype, *, device=None) -> dict:
    h, pdim, n, cw = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width
    return {
        "state": torch.zeros((batch, h, n, pdim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, cfg.d_inner + 2 * n), dtype=dtype, device=device),
    }


def decode_mamba2(p, cfg, u1, cache: dict, tp=None) -> torch.Tensor:
    """One token, u1: (B, d_model) -> (B, d_model).  ``cache``'s state and
    conv window are written in place; under ``tp`` the state is this rank's
    N block, ``y``'s partial sums over it summed over ``model``."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc_new, dt_raw = _split_proj(cfg, _in_proj(p, u1, tp))
    window = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)
    conv = torch.sum(window.float() * _conv_w(p, tp).float(), dim=1)
    xbc = F.silu(conv + p["conv_b"].float()).to(u1.dtype)
    x, B, C = torch.split(xbc, [di, n, n], dim=-1)
    split = state_split(cfg, tp)
    if split:   # B's and C's columns of this rank's N block
        block = tp.mesh.block(n, "model")
        B, C = B[:, block], C[:, block]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])          # (B,h)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(-1, h, cfg.ssm_head_dim).float()
    decay = torch.exp(A * dt)
    inp = B.float()[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]   # (B,h,n,p)
    state = cache["state"]
    state.mul_(decay[:, :, None, None]).add_(inp)
    y = (C.float()[:, None, None, :] @ state)[:, :, 0]     # (B,h,p)
    if split:
        y = reduce_from(y, tp.mesh, "model")
    y = y + p["D"][:, None] * xh
    cache["conv"].copy_(window[:, 1:])
    return _gated_out(p, y.reshape(-1, di), z, u1.dtype, tp)
