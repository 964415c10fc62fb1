"""End-to-end federated training: the runnable launcher.

Counterpart of ``repro/launch/train.py``: the same arguments, printed lines
and numpy draws (the eval batch before the rounds, each round's client
batches, a VLM's patch and an audio model's frame embeddings after the
tokens), so one seed gives both packages the same batches.  Weights come
from a ``torch.Generator`` seeded 0 (the port cannot replay
``jax.random.PRNGKey(0)``).  ``--device`` picks the card (default) or the
CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --rounds 2 --byzantine 1 --ckpt /tmp/ck.msgpack
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --device cpu --rounds 2 --clients 4 --seq 64 --byzantine 1

Two workloads (``--workload``):

* ``full`` (default): every client trains the whole model and proposes
  full parameters, through ``repro_torch.fed.distributed.make_fed_round`` in
  the config's ``fed_mode`` (``vmap`` under ``--reduced``, which also forces
  float32);
* ``lora``: clients train low-rank adapters on a frozen base, through the
  fused engine (``repro_torch.fed.api.run``), with ``--byzantine`` clients
  running the update-level attack ``--scenario``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core import AFAConfig, init_reputation
from repro_torch.data import make_token_stream
from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
from repro_torch.models import build_model


def make_fed_batches(cfg, stream, rng, *, K, S, b, seq, device="cuda"):
    """K clients' batches for S local steps of ``b`` sequences, leaves
    ``(K, S, b, ...)`` on ``device``, drawn from ``rng`` as the reference
    draws them."""
    toks = []
    for _ in range(K):
        batch = next(iter(stream.batches(rng, batch=S * b, seq=seq, n_batches=1)))
        toks.append({k: v.reshape(S, b, seq) for k, v in batch.items()})
    batch = {k: np.stack([t[k] for t in toks]) for k in toks[0]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(K, S, b, cfg.prefix_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch = {
            "frame_embeds": rng.normal(size=(K, S, b, seq, cfg.frontend_dim)).astype(np.float32),
            "labels": batch["labels"],
        }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def byzantine_batches(batch, n: int, rnd: int, vocab: int) -> None:
    """The first ``n`` clients of round ``rnd`` turn byzantine, in place:
    paper-style, labels scrambled AND a constant label (mode collapse), a
    strong, systematic wrong gradient; their tokens are zeroed (an audio
    model's inputs are frames, left as drawn)."""
    for k in range(n):
        batch["labels"][k] = rnd % vocab
        if "tokens" in batch:
            batch["tokens"][k] = 0


def run_lora(args) -> int:
    """The ``--workload lora`` route: fused-engine federated fine-tuning on
    low-rank adapter proposals (``repro_torch.fed.workload``)."""
    from repro_torch.fed.api import run
    from repro_torch.fed.simulator import SimConfig
    from repro_torch.fed.workload import get_workload

    workload = get_workload("lora", arch=args.arch, reduced=args.reduced, rank=args.rank)
    sim = SimConfig(
        num_clients=args.clients, bad_frac=args.byzantine / args.clients,
        scenario=args.scenario, rounds=args.rounds,
        local_epochs=args.local_steps, batch_size=args.batch, lr=args.lr,
    )
    t0 = time.perf_counter()
    res = run(workload, sim, seq=args.seq, device=args.device)
    dt = time.perf_counter() - t0
    print(
        f"lora workload: adapter_dim={res['adapter_dim']} "
        f"({100 * res['adapter_fraction']:.2f}% of {res['param_dim']} params)",
        flush=True,
    )
    for rnd, (err, gf) in enumerate(zip(res["test_error"], res["good_frac"])):
        blocked = int(res["blocked"][rnd].sum())
        print(
            f"round {rnd}: test_error={float(err):.4f} good_frac={float(gf):.2f} "
            f"blocked={blocked}",
            flush=True,
        )
    print(f"{args.rounds} rounds in {dt:.1f}s (one fused scan)", flush=True)
    if args.ckpt:
        save_pytree(args.ckpt, {
            "params": res["params"],
            "merged": workload.merged_params(res["params"]),
        })
        print(f"saved {args.ckpt}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--workload", choices=("full", "lora"), default="full",
                    help="full: whole-model proposals through make_fed_round; "
                         "lora: adapter-delta proposals through the fused engine")
    ap.add_argument("--rank", type=int, default=4,
                    help="LoRA rank (lora workload only)")
    ap.add_argument("--scenario", default="byzantine",
                    help="update-level attack for the byzantine clients "
                         "(lora workload only)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--byzantine", type=int, default=0,
                    help="first N clients behave byzantine: scrambled labels AND "
                         "amplified inputs (paper-style strong faults)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.workload == "lora":
        return run_lora(args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().with_(param_dtype="float32", compute_dtype="float32")
    cfg = cfg.with_(fed_clients=args.clients,
                    fed_mode=cfg.fed_mode if not args.reduced else "vmap")
    model = build_model(cfg)

    fed_round = make_fed_round(
        model,
        FedRoundConfig(
            num_clients=args.clients, local_steps=args.local_steps, lr=args.lr,
            afa=AFAConfig(), mode=cfg.fed_mode, microbatch=cfg.microbatch,
        ),
    )

    init_gen = torch.Generator(device=device)
    init_gen.manual_seed(0)
    params = model.init(init_gen, device)
    rep = init_reputation(args.clients, device=device)
    n_k = torch.ones((args.clients,), dtype=torch.float32, device=device)
    stream = make_token_stream(vocab=cfg.vocab_size, n=50_000)
    rng = np.random.default_rng(0)

    eval_batch = make_fed_batches(cfg, stream, rng, K=1, S=1, b=args.batch, seq=args.seq,
                                  device=device)
    eval_batch = {k: v[0, 0] for k, v in eval_batch.items()}

    for rnd in range(args.rounds):
        batch = make_fed_batches(cfg, stream, rng, K=args.clients, S=args.local_steps,
                                 b=args.batch, seq=args.seq, device=device)
        byzantine_batches(batch, args.byzantine, rnd, cfg.vocab_size)
        t0 = time.perf_counter()
        params, rep, metrics = fed_round(params, rep, n_k, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        with torch.no_grad():
            ev = float(model.loss_fn(params, eval_batch)[0])
        print(
            f"round {rnd}: eval_loss={ev:.4f} good_frac={float(metrics['good_frac']):.2f} "
            f"afa_rounds={int(metrics['afa_rounds'])} ({dt:.1f}s)",
            flush=True,
        )
    if args.ckpt:
        save_pytree(args.ckpt, {"params": params, "rep": rep._asdict()})
        print(f"saved {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
