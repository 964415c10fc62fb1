#!/usr/bin/env python3
"""ms a round of the client-sharded fused engine on one NVIDIA GPU, 4 gloo
ranks sharing the card, for a change to the sharded round or to AFA's
sharded screening.

    python3 tools/shard_round_sweep.py [--before DIR] [--pairs N]

Every run is ``chip_smoke.py``'s phase H run (``SHARD_SIM``): the paper DNN
at full width (784 x 512 x 256 x 10), 160 clients of which 48 byzantine,
1,250 samples a client, 8 rounds in 2-round segments with per-shard
compaction (40 rows a shard, then 32), local_epochs 2 of batch 200, seed 0,
iterative AFA on the kernel route, through
``repro_torch.launch.shards.run_sharded`` on 4 gloo ranks on ``cuda:0``.

1. The round: each run in a process of its own, its ms a round by segment
   (a segment's wall over its rounds) and the median of the rounds after
   the first segment (which holds each rank's first launches and, in a
   tree's first run, the kernels' build).  With ``--before`` (a checkout
   of another commit, e.g. unpacked with ``git archive`` into a directory
   that ``.gitignore`` lists) the runs alternate that checkout's ``src``
   and this one's, ``--pairs`` times in the order before, this, this,
   before, so the two are compared within one call.
2. The sharded ``afa_aggregate`` alone on this tree, on ``chip_smoke.py``'s
   seeded ``screening_inputs`` (200, 535,818) over the 4 ranks: the
   stopping loop and the unrolled form (``max_rounds`` passes under a
   device flag, the form a captured round needs) called in turn, 10 of
   each, the median ms of each (host clock around a synchronized call),
   with the all-reduces of one call.

Any failure raises.  Everything goes to ``chiprun_out/shard_round_sweep.json``.
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
K, S, N_TRAIN, AFA_K, D = 160, 4, 200_000, 200, 535_818
SIM = dict(num_clients=K, bad_frac=0.3, scenario="byzantine", rounds=8, local_epochs=2,
           batch_size=200, hidden=(512, 256), seed=0, engine="fused", segment_rounds=2,
           client_shards=S)
TIMED = 10
TAG = "RESULT "


def round_part() -> dict:
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig
    from repro_torch.kernels.policy import resolve_kernel_plan
    from repro_torch.launch.shards import run_sharded

    data = make_mnist_like(n_train=N_TRAIN)
    server = ServerConfig(num_clients=K, afa_variant="iterative",
                          kernel_plan=resolve_kernel_plan(True))
    t0 = time.perf_counter()
    res = run_sharded(None, SimConfig(**SIM), server, data=data, device="cuda", backend="gloo")
    wall = time.perf_counter() - t0
    seg = SIM["segment_rounds"]
    bad = set(res.bad_clients.tolist())
    return {"wall_s": wall,
            "ms_by_segment": [res.round_times[i] * 1e3 for i in range(0, len(res.round_times),
                                                                     seg)],
            "median_ms_after_first_segment": statistics.median(res.round_times[seg:]) * 1e3,
            "bad_blocked": int(sum(res.blocked_round[k] > 0 for k in bad)),
            "good_blocked": int(sum(res.blocked_round[k] > 0
                                    for k in range(K) if k not in bad)),
            "final_test_error": res.test_error[-1]}


def afa_worker() -> dict:
    """One rank of part 2; returns rank 0's numbers."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import AFAConfig, afa_aggregate
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(dist.get_world_size(), "cuda")
    _, _, Us, pn, mask0 = chip_smoke.screening_inputs(torch, AFA_K, D, 7)
    blk = mesh.row_block(AFA_K // mesh.num_shards)
    local = (Us[blk].contiguous(), pn[blk], torch.ones_like(pn)[blk], mask0[blk])
    cfg = AFAConfig(variant="iterative", use_kernels="cuda", client_mesh=mesh)
    times = {False: [], True: []}
    reduces, rounds = {}, {}
    for i in range(TIMED + 1):
        for unroll in (False, True):
            before = mesh.all_reduces
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = afa_aggregate(*local, cfg, unroll=unroll)
            torch.cuda.synchronize()
            if i:   # the first call of each form warms it
                times[unroll].append((time.perf_counter() - t0) * 1e3)
            reduces[unroll] = mesh.all_reduces - before
            rounds[unroll] = int(r.rounds)
    return {("unrolled" if u else "stopping_loop"): {
        "median_ms": statistics.median(times[u]), "ms": times[u],
        "all_reduces_a_call": reduces[u], "rounds": rounds[u]} for u in (False, True)}


def afa_part() -> dict:
    from repro_torch.launch.shards import spawn

    return spawn(afa_worker, S, backend="gloo", device="cuda:0")


def child(part: str) -> None:
    import torch

    from repro_torch import resolve_device

    resolve_device("cuda")   # TF32 off, as the simulator runs
    if not torch.cuda.is_available():
        sys.exit("shard_round_sweep: needs an NVIDIA GPU")
    out = round_part() if part == "round" else afa_part()
    print(TAG + json.dumps(out), flush=True)


def run_child(part: str, src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, __file__, "--child", part], env=env,
                          capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{part} with {src} exited {proc.returncode}")
    return json.loads(next(line for line in proc.stdout.splitlines()
                           if line.startswith(TAG))[len(TAG):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, help="another checkout, for part 1")
    ap.add_argument("--pairs", type=int, default=1,
                    help="part 1's before, this, this, before blocks (with --before)")
    ap.add_argument("--child", choices=("round", "afa"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    this = ROOT / "src"
    order = [("this", this)]
    if args.before:
        before = args.before.resolve() / "src"
        order = [("before", before), ("this", this), ("this", this), ("before", before)]
        order *= args.pairs
    out = {"nvidia_smi": smi, "round": [], "afa": None}
    for name, src in order:
        row = {"tree": name, **run_child("round", src)}
        print(f"round, {name}: ms by segment {[round(m, 3) for m in row['ms_by_segment']]}, "
              f"median after the first segment {row['median_ms_after_first_segment']:.3f}; "
              f"blocked {row['bad_blocked']} bad, {row['good_blocked']} good", flush=True)
        out["round"].append(row)
    for name in ("before", "this"):
        rows = [r["median_ms_after_first_segment"] for r in out["round"] if r["tree"] == name]
        if rows:
            print(f"round, {name}: medians {[round(m, 3) for m in rows]}, their median "
                  f"{statistics.median(rows):.3f} ms ({smi})", flush=True)
    out["afa"] = run_child("afa", this)
    for form, row in out["afa"].items():
        print(f"afa_aggregate alone ({AFA_K}, {D}) over {S} gloo ranks, {form}: median "
              f"{row['median_ms']:.3f} ms, {row['all_reduces_a_call']} all-reduces a call, "
              f"rounds {row['rounds']} ({smi})", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "shard_round_sweep.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
