"""Input specs for every (arch x input shape) combo on one card.

Counterpart of ``repro/launch/specs.py``: the same four production shapes
(``INPUT_SHAPES``), the same step kinds, argument order, skips and cache
sizes.  The reference builds ``jax.ShapeDtypeStruct`` stand-ins with mesh
shardings; here the arguments are tensors made on ``device``:

* ``device="meta"`` (the default) allocates nothing and draws nothing: the
  shapes and dtypes alone, for the dry run;
* a real device (``"cuda"``, or ``"cpu"`` for tests) makes real tensors:
  the weights through ``model.init`` with a ``torch.Generator`` seeded 0,
  the tokens and embeddings from one seeded 1, a cache's float leaves
  from one seeded 2 (normals); a decode step's ``pos`` is ``seq - 1``,
  every earlier position in the cache.

The reference's mesh is replaced by ``client_rows``, the counterpart of
``num_client_rows(mesh)`` (``repro/launch/mesh.py``): one card gives 1, as
the reference's one-device mesh does, and other values stand for the rows
of a larger mesh (the clients of a ``vmap`` round).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.reputation import ReputationState
from repro_torch.models.model import tree_apply

INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="long_decode", seq=524_288, global_batch=1),
}

LOCAL_STEPS = 4  # client SGD steps per federated round


@dataclasses.dataclass
class SpecBundle:
    step_kind: str          # train | prefill | decode | forward | skip
    args: tuple             # tensors in call order
    meta: dict              # bookkeeping for the dry run and the analytic model
    skip_reason: str | None = None


def _device(device) -> torch.device:
    device = torch.device(device)
    return device if device.type == "meta" else resolve_device(device)


def _generator(device: torch.device, seed: int):
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _ints(shape, high: int, gen, device) -> torch.Tensor:
    if gen is None:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int32, device=device)


def _normals(shape, dtype, gen, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    return out if gen is None else out.normal_(generator=gen)


def _token_batch(cfg, *, lead: tuple, seq: int, gen, device) -> dict:
    """Tokens and labels (and a frontend's embeddings) of leading dims
    ``lead`` + (seq,), as the reference's ``_token_batch_specs``."""
    shp = lead + (seq,)
    out = {"tokens": _ints(shp, cfg.vocab_size, gen, device),
           "labels": _ints(shp, cfg.vocab_size, gen, device)}
    if cfg.family == "vlm":
        out["patch_embeds"] = _normals(lead + (cfg.prefix_len, cfg.frontend_dim), cfg.cdtype,
                                       gen, device)
    if cfg.family == "audio":
        out = {"frame_embeds": _normals(shp + (cfg.frontend_dim,), cfg.cdtype, gen, device),
               "labels": out["labels"]}
    return out


def fed_client_count(cfg, client_rows: int = 1) -> int:
    return client_rows if cfg.fed_mode == "vmap" else cfg.fed_clients


def param_specs(model, *, device="meta", seed: int = 0):
    """The model's parameters on ``device``, drawn from ``seed`` on a real
    one."""
    dev = _device(device)
    return model.init(_generator(dev, seed), dev)


def reputation_specs(K: int, device="meta") -> ReputationState:
    """The prior Beta(3, 3) of ``init_reputation`` for K clients, none
    blocked."""
    dev = _device(device)
    return ReputationState(
        alpha=torch.full((K,), 3.0, dtype=torch.float32, device=dev),
        beta=torch.full((K,), 3.0, dtype=torch.float32, device=dev),
        blocked=torch.zeros((K,), dtype=torch.bool, device=dev),
    )


def cache_specs(model, batch: int, cache_size: int, *, device="meta", seed: int = 2) -> dict:
    """``model.init_cache`` on ``device``; on a real device every float
    leaf is filled with normals from ``seed``."""
    dev = _device(device)
    cache = model.init_cache(batch, cache_size, model.config.cdtype, device=dev)
    gen = _generator(dev, seed)
    if gen is not None:
        tree_apply(lambda t: t.normal_(generator=gen) if t.is_floating_point() else t, cache)
    return cache


def input_specs(model, shape_name: str, client_rows: int = 1, *, local_steps: int | None = None,
                device="meta", global_batch: int | None = None) -> SpecBundle:
    """The full argument list of the step this (arch, shape) runs.
    ``global_batch`` cuts the shape's batch to what one card holds (the
    ``meta`` records the cut value)."""
    cfg = model.config
    steps_per_round = local_steps or LOCAL_STEPS
    info = INPUT_SHAPES[shape_name]
    seq, gb = info["seq"], global_batch or info["global_batch"]
    kind = info["kind"]

    if cfg.is_encoder and kind in ("decode", "long_decode"):
        return SpecBundle(
            step_kind="skip", args=(), meta={},
            skip_reason=f"{cfg.name} is encoder-only: no decode step (DESIGN.md)",
        )

    meta = dict(arch=cfg.name, shape=shape_name, seq=seq, global_batch=gb,
                client_rows=client_rows)
    if kind == "long_decode" and cfg.family != "ssm" and not cfg.sliding_window:
        return SpecBundle(
            "skip", (), meta,
            skip_reason=f"{cfg.name}: full attention at 500k is quadratic; "
            "no sliding-window variant configured (DESIGN.md)",
        )

    dev = _device(device)
    params = param_specs(model, device=dev, seed=0)
    gen = _generator(dev, 1)

    if kind == "train":
        K = fed_client_count(cfg, client_rows)
        b = max(gb // K, 1) if cfg.fed_mode == "vmap" else gb
        batch = _token_batch(cfg, lead=(K, steps_per_round, b), seq=seq, gen=gen, device=dev)
        rep = reputation_specs(K, dev)
        n_k = torch.ones((K,), dtype=torch.float32, device=dev)
        meta.update(num_clients=K, local_steps=steps_per_round, per_client_batch=b,
                    fed_mode=cfg.fed_mode)
        return SpecBundle("train", (params, rep, n_k, batch), meta)

    if kind == "prefill":
        batch = _token_batch(cfg, lead=(gb,), seq=seq, gen=gen, device=dev)
        if cfg.is_encoder:
            return SpecBundle("forward", (params, batch), meta)
        # VLM prefill also caches the image-prefix positions
        meta.update(cache_size=seq + (cfg.prefix_len if cfg.family == "vlm" else 0))
        return SpecBundle("prefill", (params, batch), meta)

    # decode kinds
    if kind == "long_decode":
        # an SSM's cache ignores the sequence length
        cache_size, ring = (1, False) if cfg.family == "ssm" else (cfg.sliding_window, True)
    else:
        cache_size, ring = seq, False
    cache = cache_specs(model, gb, cache_size, device=dev, seed=2)
    tokens = _ints((gb,), cfg.vocab_size, gen, dev)
    pos = torch.full((gb,), seq - 1, dtype=torch.int32, device=dev)
    cache["pos"].copy_(pos)
    meta.update(cache_size=cache_size, ring=ring)
    return SpecBundle("decode", (params, cache, tokens, pos), meta)
