"""One-card dry run: build every (arch x input shape) without allocating,
and report its bytes, its counted FLOPs and the analytic model.

Counterpart of ``repro/launch/dryrun.py`` on one card.  The reference lowers
and compiles each step on a TPU mesh and reads XLA's memory and cost
analyses; the port has no HLO, so on ``--device meta`` (the default) each
record holds:

* ``memory.argument_bytes`` and ``output_bytes``: the bytes of the step's
  argument tensors (``specs.input_specs``) and of what it returns;
* ``flops_counted``: ``torch.utils.flop_counter.FlopCounterMode`` over one
  call of the step on meta tensors, on the plain attention route (the flash
  kernel is a custom op with no FLOP formula).  The plain route runs as
  one tile a layer there (``block_q = block_k`` past the sequence): its
  blocked loop computes every tile in full, masked or not, so the count is
  the blocked route's wherever the sequence is a multiple of the block (the
  VLM's prefix-lengthened sequences leave out the last block's padding).
  The train step reads the host every round (AFA's stopping loop, the
  reputation's ``betainc``) and cannot run on meta: its count is the
  clients' local training (``flops_scope: "local training"``), one
  ``_clients_train`` call under ``vmap``, else one client's
  ``_client_train`` times the calls the mode makes (``flops_calls``, from
  ``fed.distributed.client_train_calls``), each counted over one local
  step and multiplied by the steps: every call and step has the same
  shapes;
* ``analytic``: ``analytic.analytic_report(cfg, shape, client_rows)``.

``--device cuda`` also makes the arguments on the card, where they fit its
free memory (``torch.cuda.mem_get_info``), runs the step once and adds
``ms`` and ``peak_bytes`` (``max_memory_allocated`` after a reset); where
they do not fit, the record is an ``error`` with their byte count.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cuda

One JSON a combo under ``experiments/dryrun_torch/``, named
``<arch>__<shape>__<device>[__<variant>].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.fed.distributed import _client_train, _clients_train, client_train_calls
from repro_torch.launch.analytic import analytic_report
from repro_torch.launch.specs import INPUT_SHAPES, input_specs
from repro_torch.launch.steps import build_step, train_round_config
from repro_torch.models import build_model
from repro_torch.optim import sgd_momentum

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
ONE_TILE = 1 << 30  # block_q = block_k past any sequence: one tile a layer

# The reference's named deviations from the baseline.  cfg: ModelConfig
# overrides; train: make_train_step kwargs.  activation_sharding,
# fsdp_activations and seq_par_attention are mesh levers with no effect on
# one card; their variants keep their other knobs.
VARIANTS = {
    "baseline": {},
    "afa_gram": {"train": {"afa_variant": "gram"}},
    "scan_int8": {"cfg": {"fed_mode": "scan"}, "train": {"proposal_dtype": "int8"}},
    "scan_bf16": {"cfg": {"fed_mode": "scan"}, "train": {"proposal_dtype": "bfloat16"}},
    "local8": {"train": {"local_steps": 8}, "local_steps": 8},
    "act_shard": {"cfg": {"activation_sharding": True}},
    "microbatch8": {"train": {"microbatch": 8}},
    "act_shard_mb8": {"cfg": {"activation_sharding": True}, "train": {"microbatch": 8}},
    "scan_int8_mb8": {"cfg": {"fed_mode": "scan"},
                      "train": {"proposal_dtype": "int8", "microbatch": 8}},
    "scan_int8_mb32": {"cfg": {"fed_mode": "scan"},
                       "train": {"proposal_dtype": "int8", "microbatch": 32}},
    "remat_mb32": {"train": {"microbatch": 32}},
    "fsdp_act": {"cfg": {"fsdp_activations": True}},
    "fsdp_act_mb8": {"cfg": {"fsdp_activations": True}, "train": {"microbatch": 8}},
    "scan_int8_fsdp_mb8": {"cfg": {"fed_mode": "scan", "fsdp_activations": True},
                           "train": {"proposal_dtype": "int8", "microbatch": 8}},
    "seq_par": {"cfg": {"seq_par_attention": True, "block_q": 2064}},
    "scan_int8_act_mb32": {"cfg": {"fed_mode": "scan", "activation_sharding": True},
                           "train": {"proposal_dtype": "int8", "microbatch": 32}},
    "scan_int8_fsdp_mb32": {"cfg": {"fed_mode": "scan", "fsdp_activations": True},
                            "train": {"proposal_dtype": "int8", "microbatch": 32}},
    "scan_int8_fsdp_mb16": {"cfg": {"fed_mode": "scan", "fsdp_activations": True},
                            "train": {"proposal_dtype": "int8", "microbatch": 16}},
    "afa_gram_act": {"cfg": {"activation_sharding": True}, "train": {"afa_variant": "gram"}},
}


def nbytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, tuples, named tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(nbytes(v) for v in tree)
    return 0


def count_step(model, bundle, train_kwargs: dict) -> dict:
    """FLOPs and output bytes of one call of the bundle's step on its meta
    arguments (for a train step: its local training, see the module)."""
    if bundle.step_kind != "train":
        step = build_step(model, bundle)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            out = step(*bundle.args)
        return {"flops_counted": float(fc.get_total_flops()), "flops_scope": "step",
                "output_bytes": nbytes(out)}
    params, rep, n_k, batch = bundle.args
    K, S = batch["labels"].shape[:2]
    fr = train_round_config(model.config, bundle.meta["client_rows"], **train_kwargs)
    opt = sgd_momentum(fr.lr, fr.momentum)
    first = {n: v[:, :1] for n, v in batch.items()}  # one local step
    with FlopCounterMode(display=False) as fc:
        if fr.mode == "vmap":
            _clients_train(model.loss_fn, opt, params, first, microbatch=fr.microbatch)
        else:
            _client_train(model.loss_fn, opt, params, {n: v[0] for n, v in first.items()},
                          microbatch=fr.microbatch)
    calls = client_train_calls(fr.mode, K)
    # (params', rep', metrics): the aggregate in the parameters' dtypes,
    # good_frac f32, afa_rounds int32, K f32 similarities
    return {"flops_counted": float(fc.get_total_flops()) * S * calls,
            "flops_scope": "local training", "flops_calls": calls,
            "output_bytes": nbytes(params) + nbytes(rep) + 4 + 4 + 4 * K}


def run_on_card(cfg, shape_name: str, arg_bytes: int, local_steps, train_kwargs: dict) -> dict:
    """The step once on the card with real arguments: ms and peak bytes, or
    an error when the arguments do not fit its free memory."""
    dev = resolve_device("cuda")
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    if arg_bytes > free:
        raise MemoryError(f"the arguments take {arg_bytes} bytes; the card has {free} free")
    model = build_model(cfg)
    bundle = input_specs(model, shape_name, local_steps=local_steps, device=dev)
    step = build_step(model, bundle, **train_kwargs)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.set_grad_enabled(bundle.step_kind == "train"):
        step(*bundle.args)
    torch.cuda.synchronize(dev)
    return {"ms": (time.perf_counter() - t0) * 1e3,
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_one(arch: str, shape_name: str, out_dir, *, device: str = "meta", force: bool = False,
            variant: str = "baseline") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    vtag = "" if variant == "baseline" else f"__{variant}"
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{device}{vtag}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)

    vspec = VARIANTS[variant]
    cfg = get_config(arch)
    if vspec.get("cfg"):
        cfg = cfg.with_(**vspec["cfg"])
    train_kwargs = vspec.get("train", {})
    rec = {"arch": arch, "shape": shape_name, "device": device, "variant": variant,
           "num_chips": 1, "status": "error"}
    try:
        counting = build_model(cfg.with_(use_pallas_attention=False, block_q=ONE_TILE,
                                         block_k=ONE_TILE))
        bundle = input_specs(counting, shape_name, local_steps=vspec.get("local_steps"))
        rec["meta"] = bundle.meta
        if bundle.step_kind == "skip":
            rec["status"] = "skip"
            rec["skip_reason"] = bundle.skip_reason
            _dump(fname, rec)
            return rec
        arg_bytes = nbytes(bundle.args)
        counted = count_step(counting, bundle, train_kwargs)
        rec["memory"] = {"argument_bytes": arg_bytes, "output_bytes": counted.pop("output_bytes")}
        rec.update(counted)
        rec["analytic"] = analytic_report(cfg, shape_name, bundle.meta["client_rows"])
        if device == "cuda":
            rec.update(run_on_card(cfg, shape_name, arg_bytes, vspec.get("local_steps"),
                                   train_kwargs))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- each combo must report, not die
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _dump(fname, rec)
    return rec


def _dump(fname, rec):
    with open(fname, "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (see repro_torch.configs.ALIASES)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta (default): shapes only; cuda: also run each step on the card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        resolve_device("cuda")  # raises without CUDA

    archs = list(ALIASES) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]

    results = []
    for arch in archs:
        for shape in shapes:
            t0 = time.perf_counter()
            rec = run_one(arch, shape, args.out, device=args.device, force=args.force,
                          variant=args.variant)
            dt = time.perf_counter() - t0
            line = f"[{rec['status']:5s}] {arch:22s} {shape:12s} {args.device:5s} ({dt:6.1f}s)"
            if rec["status"] == "ok":
                line += (f" args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB "
                         f"flops={rec['flops_counted']:.4g} "
                         f"analytic={rec['analytic']['analytic_flops']:.4g}")
                if "ms" in rec:
                    line += f" ms={rec['ms']:.1f} peak={rec['peak_bytes'] / 2**30:.2f}GiB"
            elif rec["status"] == "skip":
                line += f" {rec['skip_reason']}"
            else:
                line += f" {rec['error'][:120]}"
            print(line, flush=True)
            results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skip, {n_err} error ==")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
