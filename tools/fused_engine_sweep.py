#!/usr/bin/env python3
"""Round times of the paper DNN's engines at K = 10 and K = 200 clients on one
NVIDIA GPU, for a change to the round body or to AFA's screening loop.

    python3 tools/fused_engine_sweep.py [--before DIR]

Every run is ``chip_smoke.py``'s ``MAIN_SIM`` with K clients: the DNN at
full width (784 x 512 x 256 x 10), 1,000 samples a client (the main path's
shard), 30 % byzantine, 8 rounds, local_epochs 2 of batch 200 (10 steps a
round), seed 0.

1. The batched engine on the four AFA routes (iterative, gram/chained and
   gram/fused on the kernels, iterative on plain torch) at each K: each run
   made twice, the second one's median round, train and aggregation ms
   kept, with its blocked clients and final test error.  With ``--before``
   (a checkout of another commit, e.g. unpacked with ``git archive`` into a
   directory that ``.gitignore`` lists) this part runs in four processes,
   that checkout's ``src``, this one's, this one's, that one's, so the two
   are compared within one call.
2. The fused engines at the largest K on the kernel routes gram/fused,
   gram/chained, iterative and comed: ``engine="fused_eager"`` and
   ``"fused"`` through ``run``; capture seconds, ms a round of the replayed
   graph without the capture ((run - capture) / T) and of the eager body,
   and whether the graph's trajectory equals the eager one bit for bit.

Any failure raises.  Everything goes to ``chiprun_out/fused_engine_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KS = (10, 200)
PER_CLIENT = 1_000
SIM = dict(bad_frac=0.3, scenario="byzantine", rounds=8, local_epochs=2, batch_size=200,
           hidden=(512, 256), seed=0)
BATCHED_ROUTES = {  # label -> (rule, afa_variant, kernel_launch, kernel route?)
    "iterative": ("afa", "iterative", "fused", True),
    "gram/chained": ("afa", "gram", "chained", True),
    "gram/fused": ("afa", "gram", "fused", True),
    "iterative/plain-torch": ("afa", "iterative", "fused", False),
}
FUSED_ROUTES = {**{k: BATCHED_ROUTES[k] for k in ("gram/fused", "gram/chained", "iterative")},
                "comed": ("comed", "iterative", "fused", True)}
TAG = "RESULT "


def _server(K, rule, variant, launch, kernels):
    from repro_torch.fed import ServerConfig
    from repro_torch.kernels.policy import resolve_kernel_plan

    return ServerConfig(rule=rule, num_clients=K, afa_variant=variant,
                        kernel_plan=resolve_kernel_plan(kernels, kernel_launch=launch))


def _outcome(res) -> dict:
    bad = set(res.bad_clients.tolist())
    return {"bad_blocked": int(sum(res.blocked_round[k] >= 0 for k in bad)),
            "good_blocked": int(sum(res.blocked_round[k] >= 0
                                    for k in range(len(res.blocked_round)) if k not in bad)),
            "final_test_error": res.test_error[-1]}


def batched_part(device: str, ks) -> list:
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import SimConfig, run

    rows = []
    for K in ks:
        data = make_mnist_like(n_train=PER_CLIENT * K)
        for label, route in BATCHED_ROUTES.items():
            sim = SimConfig(num_clients=K, **SIM)
            server = _server(K, *route)
            run(None, sim, server, data=data, device=device)   # warm
            res = run(None, sim, server, data=data, device=device)
            row = {"K": K, "route": label,
                   "median_round_ms": statistics.median(res.round_times) * 1e3,
                   "train_ms": res.train_time * 1e3, "agg_ms": res.agg_time * 1e3,
                   **_outcome(res)}
            print(f"batched K={K} {label}: median round {row['median_round_ms']:.3f} ms, "
                  f"train {row['train_ms']:.3f}, agg {row['agg_ms']:.3f}; blocked "
                  f"{row['bad_blocked']} bad, {row['good_blocked']} good; test error "
                  f"{row['final_test_error']}", flush=True)
            rows.append(row)
    return rows


def fused_part(device: str, K: int) -> list:
    import numpy as np

    from repro_torch.data import make_mnist_like
    from repro_torch.fed import SimConfig, run

    data = make_mnist_like(n_train=PER_CLIENT * K)
    rows = []
    for label, route in FUSED_ROUTES.items():
        server = _server(K, *route)
        res = {}
        for engine in ("fused_eager", "fused"):
            t0 = time.perf_counter()
            r = res[engine] = run(None, SimConfig(num_clients=K, **SIM, engine=engine), server,
                                  data=data, device=device)
            T = len(r.round_times)
            rows.append({"K": K, "route": label, "engine": engine,
                         "wall_s": time.perf_counter() - t0, "capture_s": r.capture_time,
                         "ms_per_round_without_capture":
                             (r.round_time * T - r.capture_time) / T * 1e3,
                         **_outcome(r)})
            print(f"fused K={K} {label} {engine}: " + ", ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rows[-1].items() if k not in ("K", "route", "engine")), flush=True)
        a, b = res["fused"], res["fused_eager"]
        same = (list(a.test_error) == list(b.test_error)
                and np.array_equal(np.stack(a.good_mask_history), np.stack(b.good_mask_history))
                and np.array_equal(a.blocked_round, b.blocked_round))
        rows[-1]["graph_equals_eager"] = rows[-2]["graph_equals_eager"] = same
        print(f"fused K={K} {label}: graph = eager bit for bit: {same}", flush=True)
        if not same:
            raise AssertionError(f"K={K} {label}: the graph's trajectory differs from the eager")
    return rows


def child(part: str, device: str, ks) -> None:
    import torch

    from repro_torch import resolve_device

    resolve_device(device)   # TF32 off, as the simulator runs
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("fused_engine_sweep: needs an NVIDIA GPU")
    rows = batched_part(device, ks) if part == "batched" else fused_part(device, max(ks))
    print(TAG + json.dumps(rows), flush=True)


def spawn(part: str, src: Path, args) -> list:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, __file__, "--child", part, "--device", args.device,
                           "--ks", args.ks],
                          env=env, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{part} with {src} exited {proc.returncode}")
    return json.loads(next(line for line in proc.stdout.splitlines()
                           if line.startswith(TAG))[len(TAG):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, help="another checkout, for part 1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ks", default=",".join(map(str, KS)),
                    help="client counts of part 1; part 2 runs at the largest")
    ap.add_argument("--child", choices=("batched", "fused"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.device, [int(k) for k in args.ks.split(",")])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip() if args.device == "cuda" else "cpu"
    print(smi, flush=True)
    this = ROOT / "src"
    order = [("this", this)]
    if args.before:
        before = args.before.resolve() / "src"
        order = [("before", before), ("this", this), ("this", this), ("before", before)]
    out = {"nvidia_smi": smi, "batched": [], "fused": []}
    for name, src in order:
        print(f"--- batched engine, {name} ({src})", flush=True)
        out["batched"].append({"tree": name, "rows": spawn("batched", src, args)})
    print("--- fused engines", flush=True)
    out["fused"] = spawn("fused", this, args)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "fused_engine_sweep.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
