#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch twin on the card at K in
   {10, 200} clients and the paper DNN's D = 535,818 parameters, gram and
   afa_screen also at the LoRA phase's K = 6, D = 460,800, and gram,
   afa_screen, weighted_sum and the masked median at the Spambase DNN's
   K = 10, D = 10,601 (odd, so every copy 4 bytes wide): agreement
   within a stated tolerance (exact for the median, which only selects),
   the two Gram kernels also against the twin of their 3xTF32 arithmetic
   (``ref.gram_3xtf32_ref``) and at edge shapes (``GRAM_EDGES``: one row,
   partial tiles, every copy width), bit-identical reruns, and times of the
   kernel, the twin and one PyTorch library call, beside the least time the
   card could take (``bound_ms``; for the Gram kernels from the TF32 rate
   of the tensor cores, with the FP32 bound of the same work beside it;
   afa_screen's bytes count U twice where U is larger than L2, since its
   aggregate pass reads U again after the Gram pass); the trimmed mean
   also bit for bit against the twin of its row-order sum
   (``ref.trimmed_mean_rowsum_ref``); then a profiler trace of one call of
   each: cosine_sim is one device operation, afa_screen three and each
   rank wrapper one, none from the wrappers (``DEVICE_OPS_PER_CALL``); and
   calls back to back on different inputs, and on a side stream beside the
   current one, each held to its own twin (their partials are summed by
   the launch's last block, which draws a per-stream ticket); the rank
   kernels at edge shapes (``RANK_EDGE_KS``: both paths and the largest K
   accepted, from a misaligned and an aligned view; all-dead, single-live
   and empty-trim masks; tied, +-0.0 and +-inf columns) bit for bit against
   their twins, a K above the largest refused, and broken plans refused by
   the C entry; ROADMAP C.8: ``gram`` and ``afa_screen`` on the live 120
   rows of a 200-row buffer and on the same rows in a 128-row buffer, bit
   for bit with the split planned for 200 rows (``plan_rows``), and how
   many entries differ without the plan and on cuBLAS's ``U @ U.T``;
4. runs the paper's experiment through ``repro_torch.fed.api.run`` at full
   width (784 x 512 x 256 x 10 DNN, K = 10, 3 byzantine clients, 8 rounds)
   on each AFA kernel route, and checks that every byzantine client is
   blocked in round ``min_rounds_to_block()`` (= 6), no good client is
   blocked, the final test error is below 5 %, and the route's kernels were
   launched;
5. runs the same experiment once for every baseline rule on the kernel
   route (and comed and trimmed_mean on the plain route too), and checks
   that the robust rules end below 5 % test error, FA above 50 % (the attack
   is live), MKRUM and Bulyan never select a byzantine client, and each
   route launched exactly its kernels; then aggregates one (K, D) matrix
   with every rule without a participation mask, as the paper's Fig. 3
   times them (the unmasked median kernel), against the plain route;
6. holds the two flash-attention kernels against their twins at the
   smollm-135m shape (B = 4, L = 2048, Hq = 9, Hkv = 3, D = 64, causal), at
   the JAX package's test shapes (causal and full, Lq != Lk included), at
   one more causal Lq != Lk case, at olmoe-1b-7b's two prefill shapes of
   step 8 (D = 128, 16/16 heads), at zamba2-1.2b's shared-block prefill
   (B = 4 x 2,048, 32/32 heads, D = 64, causal) and hubert-xlarge's encoder
   (B = 2 x 2,048, 16/16 heads, D = 80, full) of step 9, and at the
   element-load cases (D not a multiple of the elements in 16 bytes, a
   pointer off 16 bytes), each in
   f32, bf16 and f16: the exact-softmax twin within 2e-4 (f32), 2e-2 (bf16)
   and 2.5e-3 (f16); the f32 kernel (3xTF32) also within ``TF32_ATTN_RTOL``
   max |v| of ``flash_attention_3xtf32_ref``, the bf16/f16 kernel within
   one output ulp at v's scale of ``flash_attention_tc_ref``; bit-identical
   reruns; times in all three dtypes beside the bound (tensor-core
   operations, exponentials, bytes) and ``F.scaled_dot_product_attention``;
7. runs a forward of smollm-135m at full width and depth (30 layers, B = 4 x
   L = 2048 tokens, random weights from a seed) through
   ``repro_torch.models.build_model`` with the flash kernels and with the
   plain blocked attention, in f32 and in the published bf16: f32 logits of
   the two routes within 2e-3, 30 launches per forward of ``flash_attn``
   (f32) or ``flash_attn_tc`` (bf16) on the kernel route and none on the
   plain one, finite bf16 logits;
8. serves smollm-135m at full width and depth through
   ``repro_torch.launch.serve.generate`` (``SERVE_LLM``: B = 4, prompt
   2,048, 64 tokens, a linear cache of 2,112 slots) in bf16 and f32, each
   on the kernel and the plain attention route: the decode step replayed as
   one CUDA graph a token equal to the eager steps bit for bit (tokens,
   final logits, final cache), exactly 30 ``flash_attn`` (f32) or
   ``flash_attn_tc`` (bf16) launches a kernel-route prefill and none in
   decode, f32 ``logits_last`` of the two routes within 2e-3, one eager
   decode step under ``torch.cuda.set_sync_debug_mode("error")``; prefill
   ms, decode ms a token (graph and eager), capture s, tokens/s and KV-cache
   MB; one traced graph-replayed bf16 token; decode = teacher forcing (f32,
   kernel route, 16 steps after 2,048 tokens, ``SERVE_TF_TOL``, against a
   forward on the plain route); ring =
   window decode past the window (``SERVE_RING``: prompt 8,512 = 8,192 +
   320, the ring cache of 8,192 slots against the windowed linear cache,
   logits within 5e-3 a step, greedy tokens equal); olmoe-1b-7b at full
   width and depth (6.9 B parameters) in bf16 on the kernel route
   (``OLMOE_SERVE``: graph = eager bit for bit, finite logits, memory in
   use), then dropless in f32 (capacity_factor = E/k, ``OLMOE_TF``) held to
   a plain-route forward by teacher forcing (olmoe's two prefill shapes are
   also ``ATTN_SHAPES`` cases of step 6); and the launcher ``SERVE_CLI``, linear and
   ``--ring``, each exiting 0 with the reference's last line;
9. runs the registry's other families at full width and depth (phase Y,
   random weights from seed 0): mamba2-1.3b in bf16 served through
   ``generate`` (``MAMBA_SERVE``: B = 4, prompt 2,048, 64 tokens; graph =
   eager bit for bit in tokens, final logits, SSM state and conv window;
   no flash launch; an eager decode step under sync debug mode 'error'; one
   traced graph-replayed token), then f32 decode = teacher forcing
   (``FAMILY_TF``); zamba2-1.2b in bf16 served on both attention routes
   (6 ``flash_attn_tc`` launches a kernel-route prefill, the shared block's,
   none in decode) and from the ring cache past its window of 4,096
   (``ZAMBA_RING``; graph = eager), f32 prefills on both routes
   (``logits_last`` within 2e-3, 6 ``flash_attn``), f32 teacher forcing and
   ring = window decode past the window; paligemma-3b in bf16 with 256
   patch embeddings before a 512-token prompt (``PALI_SERVE``; the kernel
   asked for, the prefix-LM mask keeps every layer on the plain attention:
   0 flash launches; graph = eager), then f32 teacher forcing
   (``PALI_TF``); hubert-xlarge's forward and loss at B = 2 x 2,048 frames
   in bf16 and f32 on both routes (48 non-causal flash launches a
   kernel-route forward, f32 logits within 2e-3, the last frame zeroed
   moves the first frame's logits); prefill ms, decode ms a token (graph
   and eager), capture s, tokens/s and cache and SSM-state MB (zamba2's
   shared blocks' and hubert's shapes are also ``ATTN_SHAPES`` cases of
   step 6);
10. trains whole models federated (phase T, ``TRAIN_RUN``): smollm-135m at
   full width and depth (162,826,560 parameters, random weights from seed
   0) through ``repro_torch.fed.distributed.make_fed_round`` on the train
   CLI's batches (K = 4, client 0 byzantine by the CLI's attack, 2 local
   steps of 2 x 128 tokens), every mode of ``TRAIN_MODES`` (vmap, scan
   storing f32, bf16 or int8 deltas, remat, vmap with one screening pass)
   for 2 rounds in bf16 and one round on an f32 copy of the weights:
   exactly client 0 screened out in every round, a client retrained from
   the same start the same bits, round 1 of scan and remat within
   ``TRAIN_BOUNDS`` of vmap (f32: the reference tests' tolerances),
   remat's reputation = vmap's with one pass, scan's and remat's peak of
   allocated memory below vmap's; ms a round, peak GB and eval loss; then
   ``repro_torch.launch.train`` as a user runs it (``TRAIN_CLI``): every
   round prints ``good_frac=0.75`` and its checkpoint loads back through
   ``load_pytree`` equal bit for bit to the vmap run, bf16 leaves and all;
11. runs smollm-135m at full width and depth (bf16, seed 0) at the
   reference's production input shapes (phase D, ``repro_torch.launch
   .specs.INPUT_SHAPES``) through ``input_specs(..., device="cuda")`` and
   ``build_step``: ``prefill_32k`` (B = 32 x 32,768) on the kernel route,
   30 ``flash_attn_tc`` launches a prefill, logits finite, ms (median of 3),
   peak GB, analytic FLOP/s and the model-FLOP share; in f32 at B = 1 the
   kernel-route forward within 2e-3 of the plain route at 16,384 tokens
   and the 32,768-token prefill's ``logits_last`` within 2e-3 of the
   forward's last position (30 ``flash_attn`` launches each), both flash
   kernels against the twins of their arithmetic at 32,768 tokens, the f32
   one at B = 1 and the bf16 one at the prefill's B = 32 (its first and
   last rows each against the twin on that row), each beside
   ``F.scaled_dot_product_attention``'s time on the same inputs (GQA,
   causal), or the bytes it asked for where it does not fit;
   ``decode_32k`` (cut to B = 64: 128 x 32,768 take 96.6 GB of cache) and
   ``long_500k`` (a ring of 8,192 at position 524,287) from seeded caches
   used in place by a ``DecodeProgram``: one graph-replayed step = the eager
   serve step bit for bit, ms a step, the byte share, the f32 widening's
   time, one traced ``decode_32k`` replay; ``long_500k``'s ring step in
   f32 = the window decode over the same 8,192 entries; ``train_4k`` at
   ``client_rows`` = 4 (``PROD_TRAIN``: scan, the batch and local steps
   cut) screening out exactly the byzantine client, ms a round, peak GB,
   the model-FLOP share;
12. runs federated LoRA fine-tuning of smollm-135m (rank 4 on wq/wk/wv/wo,
   D_adapter = 460,800; 6 clients, 2 byzantine, 8 rounds) through
   ``repro_torch.fed.api.run`` on the AFA gram/fused kernel route and on the
   plain route, each on the fused engine as ``simulate_llm`` runs it (the six
   clients trained together, the round captured once as a CUDA graph and
   replayed) and as its eager body (``eager=True``): graph = eager bit for
   bit in test error, good_mask, blocked set and final adapters, both
   byzantine clients blocked in round 6, no benign client blocked, the same
   blocking decisions on both routes; round 7's ``server_step`` inputs are
   recorded from both routes' eager runs, the kernel route's go to
   ``chiprun_out/``, and each live client's f32 margin to the first
   screening pass's tail threshold is printed, on the kernel's Gram and on
   ``U @ U.T`` (ROADMAP C.6: a benign client sits within f32 rounding of it
   there, so the routes' ``good_mask`` is not compared);
13. runs the paper's experiment (step 4's configuration) through ``run`` on
   the fused engines (``FUSED_ROUTES``: the three AFA kernel routes, the
   plain route, comed's and trimmed_mean's kernel routes), each with
   ``engine="fused"`` (one round captured as a CUDA graph and replayed) and
   ``"fused_eager"`` (the same round body called once a round): the graph's
   trajectory equal to the eager one bit for bit, step 4's outcome gates,
   and the gram/fused route also in segments of 2 rounds with compaction,
   blocking and screening as the one-shot run does; one eager round of each
   route under ``torch.cuda.set_sync_debug_mode("error")``; round 5's keyed
   Philox draws on the card equal to the CPU's (the normals within
   ``KEYED_NORMAL_ATOL``); capture time and ms a round; then ROADMAP C.8
   end to end (``C8_SIM``: 180 clients, 54 byzantine, 1,000 samples a
   client): one shot against 2-round segments, compacted from 180 to 128
   rows after round 6, bit for bit on the two gram kernel routes, the
   plain routes reported; and 200 clients with 40 % byzantine once, its
   blocking reported;
14. traces three rounds of the paper DNN's gram/fused route and one bf16
   and one f32 forward of smollm-135m on the kernel route with
   ``torch.profiler`` (device busy share, the kernels that take the time),
   one ``engine="fused"`` run of each ``FUSED_ROUTES`` route, the segmented
   run and one LoRA run of step 12's gram/fused route (each of the route's
   kernels exactly its count a round times the rounds the run executed:
   its warm-up rounds, which the wrappers count, and the T replayed ones,
   which only the trace sees; from the first replayed round on exactly T
   times; the busy share, device ms and events of the replayed rounds) and
   the batched engine's eight rounds on the gram/fused route beside it;
   then runs step 4's configuration as a seed sweep (``SWEEP_SEEDS`` 0-3,
   ``run(..., seeds=)``: one capture a sweep, every seed replaying it) on
   gram/fused and the plain route, and on gram/fused in 2-round segments
   compacted on the union of the clients live in any seed: the row of seed
   0 equal to step 13's ``engine="fused"`` run bit for bit, segmented =
   unsegmented bit for bit, every seed blocking the 3 byzantine clients in
   round 6, each seed's detection rate and mean rounds to block printed;
15. drives the serve tier (``repro_torch.serve``) at step 4's configuration:
   ``run_serve_replay`` with the default ``ServeConfig`` on gram/fused,
   gram/chained, iterative and the plain route, each equal bit for bit to
   the route's ``engine="fused"`` run of step 13 (test error, blocked rounds,
   good_mask history), with step 4's outcome gates, no rejection and each
   kernel route's kernels launched; then ``run_traffic`` on gram/fused
   (``SERVE_ASYNC``, ``SERVE_TRAFFIC``, 20 rounds), twice: exactly the
   byzantine clients blocked, at least 95 % of their reconnects rejected at
   ingress, the same ingress log, test errors and fire times; readings of
   each aggregation step, cohort propose and submit, the host-device bytes
   of a round, the copies' times and the busy share of 8 traced replay
   rounds;
16. runs the paper's Tables 1 and 2 at the published widths (``GRID_DATA``:
   MNIST-like 784 x 512 x 256 x 10, D = 535,818, and Spambase-like 54 x 100
   x 50 x 1, D = 10,601; 10 clients of which 3 bad, 8 rounds): clean,
   byzantine, flipping and noisy under AFA gram/fused, AFA on the plain
   route, fa, mkrum and comed on the batched engine, each kernel route
   launching exactly its kernels: byzantine and flipping clients blocked in
   round 6 by both AFA routes, no good client blocked, none on clean data,
   AFA's round-8 test error under 5 % (MNIST-like) and 15 % (Spambase-like);
   on noisy data the noisy clients each AFA route blocked beside the JAX
   package's; every round's inputs of both routes screened by afa_screen
   and by the plain screen alike, but where the two screens first decide
   apart, in that pass, a tie (each client decided apart within
   ``NOISY_TIE`` of its threshold in float64); where the routes block
   apart, the first round that splits them a tie in the same sense, the
   kernel screen on the kernel route's inputs against the plain screen on
   the plain route's, its margins a pass printed; then AFA
   gram/fused with ``engine="fused"`` against ``"fused_eager"`` under
   byzantine and noisy on both datasets, graph = eager bit for bit;
17. runs ``MAIN_SIM`` and its noisy scenario with ``engine="looped"`` (one
   client at a time) against ``"batched"`` on gram/fused: equal good_mask
   histories and blocked rounds, test error within 0.5 pp, ms a round of
   each;
18. runs ``MAIN_SIM`` on the leaf layout (``KernelPlan(mode="cuda",
   layout="leaf")``, AFA's tree form, both variants): byzantine blocked in
   round 6 with no AFA kernel launched; then one ``server_step`` on round
   3's recorded proposals on the leaf and the tree layouts: AFA's good_mask
   equal and its aggregate within rtol 2e-5 / atol 2e-6, fa, mkrum and
   comed bit for bit, each launching its kernel on the leaf layout;
19. runs the client-sharded fused engine (phase H, ``SHARD_SIM``: the paper
   DNN at full width, 160 clients, 48 byzantine, 8 rounds in 2-round
   segments, iterative AFA on the kernel route; the last segment compacted
   per shard, from 40 rows a shard to 32):
   ``launch.shards.run_sharded`` on one NCCL rank = the unsharded
   ``engine="fused"`` run bit for bit; 4 gloo ranks sharing the card
   (``launch.shards.spawn``): every round's good_mask and the blocked
   rounds equal the unsharded run's, test error within 1e-4, the 48
   blocked in round 6 and no good client, the rows a shard 40 and then 32,
   the same ``weighted_sum`` and ``cosine_sim`` launches on every rank, a
   pair for each screening pass of AFA's stopping loop and one more
   ``weighted_sum`` a round (wrapper counts, and rank 0's in a profiler
   trace), ms a round; the sharded ``afa_aggregate`` alone on seeded
   (200, 535,818) proposals against the unsharded call (masks and rounds
   equal, aggregate within 1e-6 of its largest magnitude), its median ms
   and one traced call split between the two kernels, the other device
   work and the host time in the all-reduces;
   with two cards or more, the run on one NCCL rank a card;
20. runs the vmap round of whole models on a (data 2, model 2) grid (phase
   N, ``model_axis_phase``; alone with ``--phase N``): smollm-135m's phase T
   round on 4 gloo ranks sharing the card, its 3 kv heads cut over 2 ranks,
   against the one-card round (f32 within ``AXIS_F32``, bf16 within
   ``TRAIN_ROUNDING``, the posteriors, blocked bits and good_frac equal on
   every rank), every rank holding only its specs' blocks (shapes, and the
   bytes its draw left allocated), the all-reduces a round on each group as
   ``axis_all_reduces`` reckons them, no kernel launched; ms a round, peak
   GB a rank; with four cards or more, llama3-8b at full width and depth on
   one NCCL rank a card (``AXIS_BIG_RUN``: exactly client 0 screened out,
   finite losses, ms a round, peak GB, the collectives' share of a traced
   round) and one llama layer on a (data 1, model 1) grid = one card bit
   for bit;
21. runs FSDP for the scan and remat rounds, and MoE expert parallelism, on
   a (data 2, model 2) grid (phase E, ``fsdp_phase``; alone with ``--phase
   E``): smollm-135m at full width (``FSDP_LAYERS`` of its 30 layers) under FSDP in scan (bf16 and
   int8 storage) and remat, and olmoe-1b-7b at full width (64 experts, 32
   a rank) on an f32 copy cut to 1 layer in vmap (expert parallelism
   alone) and scan (with FSDP), on 4 gloo ranks sharing the card against
   the same mode's one-card round (``FSDP_MODES``, ``FSDP_MOE_MODES``):
   decisions equal on every rank, the aggregate within ``TRAIN_ROUNDING``
   (int8: one quantization step of the leaf's scale beyond; olmoe's f32
   within ``AXIS_F32``), each int8 scale the same
   bits on every rank and within ``FSDP_SCALE`` of one card's, every rank
   holding only its specs' blocks, no kernel launched; ms a round, peak GB
   a rank, the all-reduces, all-gathers and reduce-scatters a round by
   group; with four cards or more, ``FSDP_BIG`` (nemotron-4-340b's remat
   round, K = 4, and phi3.5-moe-42b's int8 scan round, K = 8, each at full
   width with its depth cut by ``fsdp_reckoning``; phi's gated rounds with
   its experts at their fan-in, after one reported round on the
   reference's draw, ``FSDP_BIG_PROBE``) on one NCCL rank a card, 3 rounds:
   exactly client 0 screened out on every rank, the eval losses finite and
   falling, the scales the same on every rank, ms a round, peak GB a rank
   against the reckoning, the collectives' share of the traced last round;
22. serves on a (data 2, model 2) grid (phase R, ``serve_grid_phase``;
   alone with ``--phase R``): smollm-135m at full width and depth in bf16
   (3 kv heads: every head on every rank, the cache split by slot) through
   ``launch.serve.generate`` on 4 gloo ranks sharing the card (B = 4,
   prompt 2,048, 64 greedy tokens, eager: gloo cannot be captured), its
   tokens one card's up to a near-tie and ``GRID_TF_STEPS`` teacher-forced
   steps within ``bf16_bound`` of one card's; an f32 copy within
   ``FWD_TOL`` / ``SERVE_TF_TOL``; olmoe-1b-7b (f32, 1 layer, heads and
   experts split) the same; every rank L flash launches a prefill and its
   cache exactly ``rank_bytes`` of its ``cache_pspec`` blocks; with four
   cards or more (alone with ``--phase R4``), ``serve_cards``:
   smollm-135m's uncut ``decode_32k`` and llama3-8b's at 32 sequences from
   ``input_specs(model, "decode_32k", grid, device="cuda")`` on one NCCL
   rank a card, each step captured = eager bit for bit and held to one
   card's decode on ``SERVE_CARDS``' rows, and llama3-8b's captured
   ``generate``;
23. prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
   Its ``launches`` are the wrappers' counts of the eager runs and of the
   serve-LLM, families, production-shape (its kernel-route prefills and
   forwards), sweep, serve, grid, looped, leaf, client-shard and grid-serving
   phases (phases T, N and E run no kernel; phases H and R summed over
   their ranks) and, for the
   fused engine's
   graph runs (the DNN's and LoRA's), the calls that step 14's traces
   executed.

Any failure raises and exits non-zero.  Without CUDA, or without the repo's
``src/repro_torch`` beside it, the script exits 1 before printing a result.
Everything it measured also goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

D_PAPER = 784 * 512 + 512 + 512 * 256 + 256 + 256 * 10 + 10   # 535,818
KS = (10, 200)
MAIN_K = 10
# the main path's run: the paper DNN at full width, 3 of 10 clients byzantine
MAIN_SIM = dict(num_clients=MAIN_K, bad_frac=0.3, scenario="byzantine", rounds=8,
                local_epochs=2, batch_size=200, hidden=(512, 256), seed=0)
RTOL = 1e-5      # kernel vs twin, each float output on its own scale:
                 # max |diff| <= RTOL * max |twin| of that output (f32 sums
                 # over ~5e5 terms taken in different orders)
N_TIMED = 20
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than any wrapper's host work
AFA_SOURCE = "src/repro_torch/kernels/csrc/afa_kernels.cu"
RANK_SOURCE = "src/repro_torch/kernels/csrc/rank_kernels.cu"
ATTN_SOURCE = "src/repro_torch/kernels/csrc/attn_kernels.cu"
# kernel -> (TPU kernel it replaces, CUDA source)
REPLACES = {
    "weighted_sum": ("src/repro/kernels/weighted_sum.py:30", AFA_SOURCE),
    "cosine_sim": ("src/repro/kernels/cosine_sim.py:49", AFA_SOURCE),
    "gram": ("src/repro/kernels/gram.py:56", AFA_SOURCE),
    "afa_screen": ("src/repro/kernels/afa_screen.py:223", AFA_SOURCE),
    "coord_median": ("src/repro/kernels/coord_median.py:37", RANK_SOURCE),
    "coord_median_masked": ("src/repro/kernels/coord_median.py:51", RANK_SOURCE),
    "trimmed_mean": ("src/repro/kernels/trimmed_mean.py:33", RANK_SOURCE),
    "flash_attn": ("src/repro/kernels/flash_attn.py:76", ATTN_SOURCE),
    "flash_attn_tc": ("src/repro/kernels/flash_attn.py:76", ATTN_SOURCE),
}
EXACT = ("coord_median", "coord_median_masked")  # pure selection: the twin's bits
TRIM = 3         # trimmed_mean's trim, as ServerConfig.trim
DEAD = 3         # dead rows of the masked rank kernels' inputs
OUTPUTS = {"afa_screen": ("agg", "good", "rounds", "sims")}  # else one output
ROUTES = {  # label -> (afa_variant, kernel_launch, kernels the route launches)
    "iterative": ("iterative", "fused", ("cosine_sim", "weighted_sum")),
    "gram/chained": ("gram", "chained", ("gram", "weighted_sum")),
    "gram/fused": ("gram", "fused", ("afa_screen",)),
}
# baseline runs: (rule, kernel route?) -> the kernels the route launches, and
# no others
BASELINES = {
    ("fa", True): ("weighted_sum",),
    ("mkrum", True): ("gram", "weighted_sum"),
    ("comed", True): ("coord_median_masked",),
    ("trimmed_mean", True): ("trimmed_mean",),
    ("bulyan", True): ("gram", "weighted_sum", "coord_median_masked"),
    ("norm_clip", True): ("weighted_sum",),
    ("geomed", True): (),
    ("centered_clip", True): (),
    ("comed", False): (),
    ("trimmed_mean", False): (),
}
SELECTING = ("mkrum", "bulyan")  # rules whose good_mask is a selection
# device-side names of this repository's kernels
OUR_KERNEL_NAMES = ("weighted_sum_kernel", "cosine_sim_kernel", "gram_tf32x3_kernel",
                    "gram_reduce_kernel", "afa_reduce_screen_kernel", "rank_regs_kernel",
                    "rank_select_kernel", "flash_attn_tf32x3_kernel", "flash_attn_tc_kernel")
# device operations of one wrapper call at the main path's K, all this
# repository's kernels: cosine_sim one launch (its partials summed by the
# last block), afa_screen three (the Gram partials; their reduce with the
# screen in its last block; the aggregate), each rank wrapper one (the
# register path; a bool mask read in place), with no copy, fill or
# elementwise op from the wrappers
DEVICE_OPS_PER_CALL = {"cosine_sim": ("cosine_sim_kernel",),
                       "afa_screen": ("gram_tf32x3_kernel", "afa_reduce_screen_kernel",
                                      "weighted_sum_kernel"),
                       "coord_median": ("rank_regs_kernel",),
                       "coord_median_masked": ("rank_regs_kernel",),
                       "trimmed_mean": ("rank_regs_kernel",)}
# published peaks: (HBM bytes/s, FP32 non-tensor FLOP/s, dense bf16 tensor
# FLOP/s, dense TF32 tensor FLOP/s), NVIDIA data sheets (the dense rates are
# half the sparse ones)
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12, 378e12), "NVL": (3.9e12, 60e12, 835e12, 418e12),
         "SXM": (3.35e12, 67e12, 989e12, 495e12)}
# the Gram kernel against its own arithmetic's twin (ref.gram_3xtf32_ref,
# exact TF32 products summed in float64), per part: they differ only by the
# kernel's f32 sums, read at <= 6.9e-7 of a part's scale (afa_screen's sims
# at K = 200; the Gram parts <= 3.1e-7), while a kernel that drops one
# lo-term product reads >= 1.8e-4 on the off-diagonal and 1xTF32 >= 1.5e-6
# on the diagonal (tools/gram_sweep.py on an H100 SXM)
TC_RTOL = 2e-6
# exponentials a second: the SFU's 16 MUFU.EX2 per SM per clock against the
# tensor cores' 4,096 dense bf16 operations per SM per clock (CUDA
# programming guide, arithmetic instruction throughput; Hopper white paper)
EXP_PER_TENSOR_OP = 16 / 4096
# flash attention: (B, Lq, Lk, Hq, Hkv, D) of the main path, smollm-135m at
# the forward phase's B x L, and the shapes checked against the twin
ATTN_MAIN = (4, 2048, 2048, 9, 3, 64)
ATTN_SHAPES = [  # the JAX package's tests/test_kernels.py:200-205, then Lq > Lk
    ((2, 64, 64, 4, 2, 32), (True, False)),
    ((1, 100, 100, 2, 1, 64), (True, False)),
    ((2, 33, 65, 4, 4, 16), (True, False)),
    ((1, 256, 256, 8, 2, 128), (True, False)),
    ((1, 300, 130, 6, 2, 64), (True,)),
    # olmoe-1b-7b's prefills in phase V: bf16 B = 2 x 512, f32 1 x 256
    ((2, 512, 512, 16, 16, 128), (True,)),
    ((1, 256, 256, 16, 16, 128), (True,)),
    # phase Y: zamba2-1.2b's shared block in a B = 4 x 2,048 prefill, and
    # hubert-xlarge's encoder at B = 2 x 2,048 frames (D = 80 in the 128 template)
    ((4, 2048, 2048, 32, 32, 64), (True,)),
    ((2, 2048, 2048, 16, 16, 80), (False,)),
]
ATTN_TOL = {"float32": 2e-4,   # tests/test_kernels.py:219 holds the Pallas kernel to it
            "bfloat16": 2e-2,  # bf16 output rounding (8 mantissa bits)
            "float16": 2.5e-3}  # the bf16 bound scaled by f16's 3 extra mantissa bits
# the tensor-core kernel against flash_attention_tc_ref: one output ulp at
# v's scale, max |kernel - twin| <= ULP * max |v|
ATTN_TC_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# the f32 kernel against flash_attention_3xtf32_ref (exact TF32 products
# summed in float64): max |kernel - twin| <= TF32_ATTN_RTOL * max |v|.  The
# kernel reads <= 6.6e-7 of max |v| from it on an H100 SXM (its f32 sums
# inside a tile), a kernel with one lo-term product dropped 1.5e-4 and
# 1xTF32 2.4e-4 at the smollm shape (tools/attn_sweep.py); on the CPU the
# two faults read >= 5e-5 at the checked shapes
# (tests/test_torch_attention_tf32.py)
TF32_ATTN_RTOL = 3e-6
# the element-load paths: D not a multiple of the elements in 16 bytes (8 in
# bf16/f16, 4 in f32), and operands whose data starts one element past a
# 16-byte boundary: (shape, causals, misaligned)
ATTN_ELEMENT_LOADS = [((1, 77, 77, 4, 2, 20), (True, False), False),
                      ((1, 77, 77, 4, 2, 18), (True, False), False),
                      ((2, 33, 65, 4, 4, 16), (True,), True)]
FWD_B, FWD_L = 4, 2048
FWD_TOL = 2e-3   # tests/test_models.py:256 holds the JAX Pallas route to it
# the serve-LLM phase (V): smollm-135m served from a linear cache, the
# reference's decode = teacher forcing (tests/test_models.py:86, its
# tolerances) and ring = window decode past the window (:138); olmoe-1b-7b
# in bf16, then dropless (capacity_factor = E/k, tests/test_models.py:25) in
# f32; the launcher's command, linear and ring
SERVE_LLM = dict(B=4, P=2048, gen=64)          # cache 2,112 slots
SERVE_TF_STEPS = 16
SERVE_TF_TOL = (2e-3, 5e-3)                    # logits_last, each decode step
SERVE_RING = dict(B=2, P=8192 + 320, gen=32)   # l >= w and l % w != 0: the roll runs
OLMOE_SERVE = dict(B=2, P=512, gen=32)
OLMOE_TF = dict(B=1, P=256, steps=8)
# the families phase (Y): the registry's SSM, hybrid, VLM and audio models at
# full width and depth, random weights from seed 0; served shapes as phase V's
MAMBA_SERVE = dict(B=4, P=2048, gen=64)        # no attention: the SSM cache only
ZAMBA_SERVE = dict(B=4, P=2048, gen=64)        # 6 shared-block KV caches of 2,112 slots
FAMILY_TF = dict(B=1, P=512, steps=16)         # f32 decode = teacher forcing
ZAMBA_RING = dict(B=1, P=4096 + 256, gen=16)   # past zamba2's window of 4,096, roll 256
PALI_SERVE = dict(B=2, P=512, gen=32)          # after paligemma's 256 patches
PALI_TF = dict(B=1, P=128, steps=8)
HUBERT_FWD = dict(B=2, L=2048)                 # frames
SERVE_CLI = ["--arch", "smollm-135m", "--requests", "8", "--batch", "4",
             "--prompt-len", "2048", "--gen", "64"]
# the LoRA phase's run: smollm-135m at full width, 2 of 6 clients byzantine
LORA_SIM = dict(num_clients=6, bad_frac=2 / 6, scenario="byzantine", rounds=8,
                local_epochs=2, batch_size=2, seed=0, lr=0.2)
LORA_EXTRA = dict(samples_per_client=16, seq=256, n_test=16)
LORA_D = 30 * (4 * 576 * 4 + 4 * (576 + 192 + 192 + 576))  # 460,800
# gram and afa_screen are also checked at the LoRA phase's (K, D_adapter),
# where D % 4 == 0 gives the Gram kernel 16-byte copies (D_PAPER % 4 == 2
# takes 8-byte ones)
GRAM_LORA_SHAPE = (LORA_SIM["num_clients"], LORA_D)
# (K, D, byte offset of U's data) of the Gram kernel's edge cases, checked
# against the twins without times: one row; full and partial 16-row tiles;
# 32-row tiles with a partial last block; splits shorter than a stage; each
# copy width (16 bytes where D % 4 == 0, 8 where D is even, else 4, or as
# far as the offset allows)
GRAM_EDGES = [(1, 7, 0), (3, 64, 0), (16, 1001, 0), (17, 4098, 0), (33, 4096, 0),
              (33, 4096, 4), (65, 20_000, 8), (100, 3000, 0)]
# the LoRA round whose server_step inputs are kept and screened on every
# route (1-indexed; ROADMAP C.6)
LORA_DUMP_ROUND = 7
# the rank kernels' edge cases, each output bit-identical to the twins (on
# the CPU, where torch.sort keeps every element's bits): K on both sides of
# the register path's buckets and of the selection path's border, up to the
# largest K accepted; U at (D, byte offset of its data): 4-byte loads from a
# misaligned view, the widest the bucket allows from an aligned one
RANK_EDGE_KS = (1, 2, 3, 31, 32, 33, 64, 200, 1760)
RANK_EDGE_LAYOUTS = ((4099, 4), (4100, 0))
# the fused engines' phase: MAIN_SIM with engine="fused" (one CUDA graph per
# round, replayed) and "fused_eager" on each route: label -> (rule,
# afa_variant, kernel_launch, kernel route?, the wrapper calls of one
# round).  The iterative route's screening runs AFAConfig.max_rounds = 8
# passes (a cosine_sim and a weighted_sum each) plus the final weighted_sum
FUSED_ROUTES = {
    "iterative": ("afa", "iterative", "fused", True, {"cosine_sim": 8, "weighted_sum": 9}),
    "gram/chained": ("afa", "gram", "chained", True, {"gram": 1, "weighted_sum": 1}),
    "gram/fused": ("afa", "gram", "fused", True, {"afa_screen": 1}),
    "iterative/plain-torch": ("afa", "iterative", "fused", False, {}),
    "comed": ("comed", "iterative", "fused", True, {"coord_median_masked": 1}),
    "trimmed_mean": ("trimmed_mean", "iterative", "fused", True, {"trimmed_mean": 1}),
}
# the device kernels of one call of each wrapper the fused routes call, at
# MAIN_K, and the kernel that marks one call in a trace
CALL_OPS = {**DEVICE_OPS_PER_CALL, "weighted_sum": ("weighted_sum_kernel",),
            "gram": ("gram_tf32x3_kernel", "gram_reduce_kernel")}
CALL_MARK = {"weighted_sum": "weighted_sum_kernel", "cosine_sim": "cosine_sim_kernel",
             "gram": "gram_reduce_kernel", "afa_screen": "afa_reduce_screen_kernel",
             "coord_median_masked": "rank_regs_kernel", "trimmed_mean": "rank_regs_kernel"}
FUSED_SEGMENT = ("gram/fused", 2)   # the route run segmented, and its segment length
# ROADMAP C.8: the Gram of the live rows of a 200-row buffer against the same
# rows in a 128-row one; then MAIN_SIM at 180 clients (54 byzantine, 1,000
# samples a client), whose 126 live clients are compacted from 180 into a
# 128-row bucket after round 6, one shot against 2-round segments: the gram
# routes gated bit for bit, the plain routes (cuBLAS products) reported.
# 200 clients with 40 % byzantine (the JAX package's benchmarks/fused_engine.py
# case, at its small width) is run once and reported: at the paper DNN's
# width AFA blocks none of them
GRAM_BUCKET = (200, 128)
C8_K = 180
C8_BUCKET = 128
C8_SIM = dict(MAIN_SIM, num_clients=C8_K)
C8_SHARE_SIM = dict(MAIN_SIM, num_clients=200, bad_frac=0.4)
C8_ROUTES = {  # label -> (afa_variant, kernel_launch, kernel route?, wrapper calls a round)
    "gram/fused": ("gram", "fused", True, {"afa_screen": 1}),
    "gram/chained": ("gram", "chained", True, {"gram": 1, "weighted_sum": 1}),
    "gram/plain-torch": ("gram", "fused", False, {}),
    "iterative/plain-torch": ("iterative", "fused", False, {}),
}
# the serve phase (repro_torch.serve): MAIN_SIM replayed through the service
# on these routes, each against its engine="fused" run of the fused phase;
# then asynchronous traffic on gram/fused with tests/test_serve.py's
# settings, the buffer at K - 2
SERVE_ROUTES = ("gram/fused", "gram/chained", "iterative", "iterative/plain-torch")
SERVE_ASYNC = dict(buffer_size=MAIN_K - 2, deadline=4.0, max_staleness=2, staleness_decay=0.7)
SERVE_TRAFFIC = dict(seed=3, straggler_frac=0.25, burst_every=5.0)
SERVE_TARGET_ROUNDS = 20
SERVE_REJECT_MIN = 0.95   # byzantine reconnects turned away at ingress once blocked
# the keyed streams, card against CPU: the Box-Muller normals may round
# log/cos/sin's last bit differently (values |z| < 6, an ulp ~5e-7)
KEYED_NORMAL_ATOL = 1e-5
# the paper's Tables 1 and 2 at the published widths, as
# benchmarks/table1_robustness.py and table2_detection.py configure them:
# 10 clients of which 3 bad, 8 rounds, local_epochs 2, batch 200, dropout
# off, seed 0; dataset -> (data maker's arguments, hidden widths, lr, D,
# AFA's bound on round 8's test error in %)
D_SPAMBASE = 54 * 100 + 100 + 100 * 50 + 50 + 50 * 1 + 1   # 10,601
GRID_DATA = {
    "mnist": (dict(n_train=3000, n_test=800), (512, 256), 0.1, D_PAPER, 5.0),
    "spambase": ({}, (100, 50), 0.05, D_SPAMBASE, 15.0),
}
GRID_SIM = dict(num_clients=MAIN_K, bad_frac=0.3, rounds=8, local_epochs=2, batch_size=200,
                dropout=False, seed=0)
GRID_SCENARIOS = ("clean", "byzantine", "flipping", "noisy")
GRID_BLOCKING = ("byzantine", "flipping")  # every bad client blocked in round 6
# label -> (rule, afa_variant, kernel route?, the kernels the route launches)
GRID_ROUTES = {
    "afa gram/fused": ("afa", "gram", True, ("afa_screen",)),
    "afa gram/plain-torch": ("afa", "gram", False, ()),
    "fa": ("fa", "gram", True, ("weighted_sum",)),
    "mkrum": ("mkrum", "gram", True, ("gram", "weighted_sum")),
    "comed": ("comed", "gram", True, ("coord_median_masked",)),
}
GRID_FUSED = ("byzantine", "noisy")  # afa gram/fused on engine="fused" against "fused_eager"
# a screening decision whose float64 margin to its threshold, in the pass
# where two f32 screens first decide apart, is within this is a tie, which
# f32 rounding decides: about three times the largest gap read on an H100
# between a client's f32 margin and its float64 one (1.78e-7, MNIST-like
# noisy inputs; the kernel's and the plain screen split them at +3.68e-8)
NOISY_TIE = 6e-7
# the JAX package's afa (iterative variant, jnp) on the noisy scenario at
# the grid's configuration, on a CPU: noisy client -> round blocked
JAX_NOISY = {"mnist": {2: 6}, "spambase": {}}
# the looped engine against the batched one on gram/fused: MAIN_SIM and its
# noisy scenario; test error within LOOPED_ERR_PP
LOOPED_SIMS = {"byzantine": MAIN_SIM, "noisy": dict(MAIN_SIM, scenario="noisy")}
LOOPED_ERR_PP = 0.5
# seed sweeps: MAIN_SIM on the fused engine once per seed, one capture a
# sweep, on these routes (of FUSED_ROUTES), each row of MAIN_SIM's seed
# against the route's engine="fused" run; the first route also segmented
# (2-round segments, compaction on the union of the clients live in any seed)
SWEEP_SEEDS = (0, 1, 2, 3)
SWEEP_ROUTES = ("gram/fused", "iterative/plain-torch")
SWEEP_SEGMENT = 2
# the leaf layout: AFA's tree form launches no AFA kernel; one server_step on
# this round's (0-indexed, every client live) proposals on the leaf and tree
# layouts: AFA within tests/test_packed.py's bound, the matrix-only rules
# bit for bit
AFA_KERNELS = ("weighted_sum", "cosine_sim", "gram", "afa_screen")
LEAF_ROUND = 2
LEAF_RTOL, LEAF_ATOL = 2e-5, 2e-6
# the matrix-only rules, each with the kernel its leaf-layout step must launch
LEAF_EXACT_RULES = {"fa": "weighted_sum", "mkrum": "gram", "comed": "coord_median_masked"}

# phase T: federated training of whole models (repro_torch.fed.distributed,
# on repro_torch.launch.train's batches and attack) on smollm-135m at full
# width and depth in its published bf16, random weights from seed 0; the
# train CLI's defaults: K = 4 clients, 2 local steps of batch 2 x 128 tokens,
# lr 0.05, client 0 byzantine (the CLI's attack); 2 rounds a mode, and one
# round a mode on an f32 copy of the same weights
TRAIN_ARCH = "smollm-135m"
TRAIN_PARAMS = 162_826_560
TRAIN_RUN = dict(K=4, byzantine=1, local_steps=2, batch=2, seq=128, rounds=2, lr=0.05)
TRAIN_MODES = {  # label -> (mode, proposal_dtype, AFA max_rounds)
    "vmap": ("vmap", "bfloat16", 8),
    "scan/float32": ("scan", "float32", 8),
    "scan/bfloat16": ("scan", "bfloat16", 8),
    "scan/int8": ("scan", "int8", 8),
    "remat": ("remat", "bfloat16", 1),
    "vmap/max_rounds=1": ("vmap", "bfloat16", 1),
}
# How far each mode's round-1 aggregate may lie from vmap's (remat's: from
# vmap with one screening pass).  In f32, scan with f32 storage and remat at
# tests/test_fed.py:188's 1e-4 / 1e-5 and :211's 2e-3 / 2e-4 (rtol, atol).
# Otherwise the rounding bound TRAIN_ROUNDING: a twentieth of the leaf's
# largest update (tests/test_fed.py:248's bound for int8 deltas, whose
# error is at most half a step, max|d| / 254, and a convex combination keeps
# it) and two bf16 ulps of the value (2 * 2**-7).  Two causes, each rounding
# one value to a neighbour: bf16 storage rounds a proposal by half an ulp,
# and the aggregate's cast may round either way; in bf16, a client trained
# alone (scan, remat) and the same client trained beside the others (vmap)
# differ by an ulp in ~0.5 % of the weights, since cuBLAS runs (b*l, d)
# GEMMs for one client and K*b batched ones for K.
TRAIN_ROUNDING = (0.05, 2.0 ** -6)
TRAIN_BOUNDS = {("float32", "scan/float32"): (1e-4, 1e-5), ("float32", "remat"): (2e-3, 2e-4)}
TRAIN_BOUNDS.update({(d, m): "rounding" for d in ("float32", "bfloat16")
                     for m in ("scan/float32", "scan/bfloat16", "scan/int8", "remat")
                     if (d, m) not in TRAIN_BOUNDS})
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--rounds", str(TRAIN_RUN["rounds"]),
             "--byzantine", str(TRAIN_RUN["byzantine"])]

# phase D: smollm-135m at full width and depth (bf16, seed 0) at the
# reference's production input shapes (repro_torch.launch.specs.INPUT_SHAPES)
# through input_specs(..., device="cuda") and build_step.  smollm's bf16 KV
# cache takes 30 layers x 2 x 3 heads x 64 x 2 B = 23,040 B a token
PROD_ARCH = "smollm-135m"
PROD_PREFILL_B = 32        # prefill_32k's 32 x 32,768: a 24.2 GB linear cache
PROD_TIMED = 3             # prefill ms: the median of 3 after a warm-up
# decode_32k's 128 x 32,768 tokens take 96.6 GB of cache, more than the
# card's 80 GB: cut to 64 sequences (48.3 GB)
PROD_DECODE_B = 64
PROD_REPLAYS = 20          # decode: graph replays timed, the eager step 3 times
PROD_LONG_L = 16_384       # f32 kernel-route forward against the plain route, B = 1
PROD_TWIN_LS = (32_768, 16_384, 8_192)   # the flash kernels against their twins
# train_4k at client_rows = 4: K = 4 clients, client 0 byzantine (the train
# CLI's attack), 4,096-token sequences.  The plain blocked attention the
# clients train through saves every tile's scores and probabilities for its
# backward, ~36 GB a sequence for smollm at 4,096 tokens (64 tiles x 2 x
# 9 x 512 x 512 x 4 B x 30 layers), so vmap's K = 4 sequences of a
# microbatch (~145 GB) do not fit: the clients train one at a time (scan,
# bf16 storage), one sequence a microbatch; b and the local steps are cut
PROD_TRAIN = dict(client_rows=4, per_client_batch=2, local_steps=1, lr=0.05)
BF16_DENSE_PEAK = 989.4e12   # H100 SXM dense bf16 tensor-core FLOP/s: model-FLOP share
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 bytes/s: the decode byte share


# phase H (client shards): MAIN_SIM at 160 clients, 48 of them byzantine
# (ROADMAP C.8: AFA blocks all of them in round 6 at this share), iterative
# AFA on the kernel route, segmented by 2 rounds, so that the blocked set
# read after round 6 compacts the last segment: the 112 live clients fit
# 32 of the 40 rows a shard over 4 shards (128 of 160 rows unsharded);
# one NCCL rank against the unsharded run bit for bit, then 4 gloo ranks
# sharing the card against it on decisions and within SHARD_ERR_TOL; the
# sharded aggregate alone on seeded (200, D_PAPER) proposals
SHARD_K = 160
SHARD_S = 4
SHARD_SIM = dict(MAIN_SIM, num_clients=SHARD_K, bad_frac=0.3, engine="fused", segment_rounds=2)
SHARD_N_TRAIN = 200_000  # the C.8 share run's data: 1,250 samples a client
SHARD_AFA_K = 200       # rows of the sharded aggregate alone
SHARD_ERR_TOL = 1e-4    # percent: the JAX package's sharded test's bound
SHARD_AGG_RTOL = 1e-6   # aggregate vs the unsharded call, of its largest magnitude
SHARD_TIMED = 10        # sharded afa_aggregate calls timed (median)
# the wrappers a sharded round calls on each rank: a weighted_sum and a
# cosine_sim each screening pass (1 to AFA's max_rounds; the eager round
# runs the stopping loop), and the final weighted_sum
SHARD_CALLS = ("weighted_sum", "cosine_sim")
SHARD_DTYPES = ("float32", "float64", "uint8", "int32")  # what the mesh's all-reduces carry

# phase N (model axis): phase T's vmap round of smollm-135m at full width and
# depth (bf16, seed 0; the train CLI's batches, K = 4, client 0 byzantine, 2
# local steps of 2 x 128 tokens) on a (data 2, model 2) grid of 4 gloo ranks
# sharing the card, 2 clients a data row; smollm's 9 q and 3 kv heads do not
# split over 2 ranks, so its attention runs the gathered-heads route.  Held
# to the one-card round: on an f32 copy of the weights at the reference's
# sharded test's bounds, in bf16 within TRAIN_ROUNDING (a twentieth of a
# leaf's largest update and two bf16 ulps: the row-parallel products are
# rounded to bf16 on each rank before their sum, where one card rounds once),
# the posteriors, blocked bits and good_frac equal.  With four cards or more,
# llama3-8b at full width (bf16, seed 0) on one NCCL rank a card, the same
# grid: K = 4 (client 0 byzantine), 2 local steps of 1 x 512 tokens, 3
# rounds (the third traced on rank 0); and a (data 1, model 1) grid of one
# NCCL rank = the one-card round bit for bit on one llama layer.
AXIS_GRID = dict(data=2, model=2)
AXIS_F32 = (2e-4, 2e-5)           # rtol, atol
AXIS_BIG_ARCH = "llama3-8b"
AXIS_BIG_RUN = dict(K=4, byzantine=1, local_steps=2, batch=1, seq=512, rounds=3, lr=0.05,
                    layers=32)

# phase E (FSDP for scan and remat, MoE expert parallelism): on a (data 2,
# model 2) grid of 4 gloo ranks sharing the card, phase T's round (K = 4,
# client 0 byzantine, 2 local steps of 2 x 128 tokens, each client's 2 rows
# split over data) of smollm-135m at full width in bf16, cut to FSDP_LAYERS
# of its 30 layers (so that the whole script stays within its time with
# phase R after it: the full depth took ~200 s of the phase), under
# FSDP (the reference's fsdp=True specs), in each FSDP_MODES mode against
# the same mode's one-card round: the decisions equal on every rank, the
# aggregate within TRAIN_ROUNDING (int8: one quantization step of the
# leaf's scale beyond), each int8 scale the same bits on every rank and
# within FSDP_SCALE of the one-card scale; then olmoe-1b-7b at full width
# (64 experts, 32 a rank, top-8) on an f32 copy of its weights, cut to
# FSDP_MOE_LAYERS of its 16 layers, in vmap (the clients on the data rows,
# no FSDP) and scan (FSDP, f32 storage), against its one-card rounds within
# AXIS_F32.  Not bf16: its top-8 routing with a capacity a row is decided
# on the residual stream, whose bf16 rounding differs between the grid and
# one card, so a near-tied choice can send a token to another expert (at 2
# layers in bf16 the vmap round screened alike, its aggregate 1.4e-3 off in
# places, ~12 bf16 ulps).  Not 2 layers: the one-card vmap round the grid is
# held to keeps ~6 copies of K = 4 clients' weights, ~100 GB in f32.  With four cards or more, FSDP_BIG on one NCCL rank
# a card, the same grid, FSDP_BIG_RUN's rounds; each config's depth is cut
# to what fsdp_reckoning fits under ~70 GB a rank (PERF.md section 4).
FSDP_LAYERS = 15
FSDP_MODES = {"scan/bfloat16": ("scan", "bfloat16", 8), "scan/int8": ("scan", "int8", 8),
              "remat": ("remat", "bfloat16", 1)}
FSDP_SCALE = (0.05, 2.0 ** -7)    # of the scale, and of the leaf's largest weight / 127
FSDP_MOE_ARCH = "olmoe-1b-7b"
FSDP_MOE_LAYERS = 1
FSDP_MOE_MODES = {"vmap": ("vmap", "float32", 8), "scan": ("scan", "float32", 8)}
FSDP_BIG = {   # arch -> (mode, proposal dtype, AFA max_rounds, K = fed_clients, layers)
    "nemotron-4-340b": ("remat", "bfloat16", 1, 4, 1),
    "phi3.5-moe-42b-a6.6b": ("scan", "int8", 8, 8, 8),
}
FSDP_BIG_RUN = dict(byzantine=1, local_steps=2, batch=2, seq=128, rounds=3, lr=0.05)
# phi's experts: the reference's MoE init draws an expert matrix (E, d_in,
# d_out) with fan-in E = 16 (repro/models/layers.py:59), std ~0.22, so each
# MoE layer multiplies the residual stream by thousands and the experts make
# ~all of the weights' norm (~2.2e4 at 8 layers, llama3-8b's ~1.2e3).  On
# that draw the train CLI's attack lowers the byzantine proposal's cosine
# with the aggregate by ~1.2e-7 at lr 0.05, two f32 ulps, below what AFA's
# f32 mean, median and std resolve, so AFA keeps every client; at lr 0.15
# and 0.2 it screens client 0 out, but the eval loss rises after round 2 at
# both (PERF.md section 6, PR 30).  So one round on the reference's draw is
# reported (FSDP_BIG_PROBE, ungated), and the gated rounds run on the same
# draw with each expert matrix scaled to its own fan-in d_in, as a dense
# leaf is drawn (by sqrt(E / d_in), on every rank's blocks alike).
FSDP_BIG_PROBE = ("phi3.5-moe-42b-a6.6b",)

# phase R (serving on the grid): on a (data 2, model 2) grid of 4 gloo
# ranks sharing the card, smollm-135m at full width and depth (3 kv heads:
# every head gathered, the cache split by slot) served by phase V's
# generate on the kernel route, every rank given the 4 prompts and keeping
# its 2 rows, its tokens one card's up to the first step where one card's
# top-2 margin is a near-tie (a free-running greedy run follows its own
# near-ties); the grid teacher-forced with one card's generated tokens for
# GRID_TF_STEPS decode steps: its bf16 logits within GRID_BF16_REL of each
# row's largest one-card logit (16 bf16 ulps: the grid sums each layer's
# partial products in f32 and rounds once where one card rounds each
# product, and 30-32 layers of random weights compound the difference; an
# absolute 0.125, 4.5x phase V's kernel-vs-plain route difference on
# smollm's logit scale, held smollm but not llama3-8b's larger logits, 0.234
# apart), its greedy decisions one card's wherever one card's top-2 margin
# exceeds twice that bound (a near-tie below it);
# an f32 copy's logits_last within FWD_TOL and GRID_F32_STEPS decode steps
# within SERVE_TF_TOL[1], decisions equal; olmoe-1b-7b at full width on an
# f32 draw cut to FSDP_MOE_LAYERS (heads and experts split) at phase V's
# olmoe shape, the same f32 gates.  Every rank: L flash launches a
# prefill and none in decode, its cache exactly rank_bytes of the
# reference's cache_pspec blocks.  gloo's collectives cannot be captured:
# the grid decodes eagerly.  With four cards (--phase R4): SERVE_CARDS'
# decode_32k (input_specs on the grid, one NCCL rank a card) and
# SERVE_CARDS_GEN's captured generate, each held to one card on
# SERVE_CARDS' sampled rows.
GRID_BF16_REL = 2.0 ** -4
GRID_TF_STEPS = 16    # bf16 decode steps teacher-forced (gloo: ~0.83 s a step on one card)
GRID_F32_STEPS = 4
SERVE_CARDS = {   # arch -> (decode_32k's global batch, the rows one card decodes)
    "smollm-135m": (128, (0, 1, 126, 127)),   # uncut: 96.64 GB of cache, split by slot
    "llama3-8b": (32, (0, 1, 30, 31)),        # cut from 128: 137.4 GB, split by head
}
SERVE_CARDS_GEN = dict(arch="llama3-8b", B=4, P=2048, gen=64)
SERVE_CARDS_REPLAYS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def bound_ms(nbytes: float, flops: float, peaks):
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fns: dict, flush) -> dict:
    """Median device time of each function over N_TIMED turns; every turn
    times each function once, in order, after an L2 flush (the main path
    finds the (K, D) operand mostly cold).  The flush reads a 256 MB buffer,
    which leaves no dirty lines to write back; a device-side spin after it
    keeps the card busy while the host enqueues the timed call, so the
    events see the call's device time and not its host overhead.  A
    function that synchronises inside (the plain screening loop) still
    shows its host time: that is part of its cost."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(N_TIMED):
        for name, fn in fns.items():
            flush.sum()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def float_parts(torch, name, outs, refs):
    """The float outputs of one kernel as (label, kernel, twin) triples, each
    held to its own largest magnitude.  The Gram matrix's diagonal (~D) and
    its off-diagonal entries (~sqrt(D) for unrelated rows) go apart, so the
    small entries are not judged on the diagonal's scale."""
    parts = []
    for label, o, r in zip(OUTPUTS.get(name, (name,)), outs, refs):
        if o.dtype == torch.bool or o.dtype == torch.int32:
            if not torch.equal(o.cpu(), r.to(o.dtype).cpu()):
                raise AssertionError(f"{name}: {label} differs from the twin's")
            continue
        o, r = o.float(), r.float()
        if name == "gram":
            off = ~torch.eye(o.shape[0], dtype=torch.bool, device=o.device)
            parts += [("diagonal", o.diagonal(), r.diagonal()), ("off-diagonal", o[off], r[off])]
        else:
            parts.append((label, o, r))
    return parts


def hold_to_twin(torch, name, K, out_t, ref_t, rtol, twin):
    """Each float part of a kernel's outputs within ``rtol`` of the twin's
    at that part's largest magnitude, the discrete ones equal."""
    checks = []
    for label, o, r in float_parts(torch, name, out_t, ref_t):
        if o.numel() == 0:  # the off-diagonal of a 1 x 1 Gram matrix
            continue
        e, scale = float((o - r).abs().max()), float(r.abs().max())
        checks.append({"twin": twin, "part": label, "max_abs_err": e, "twin_max_abs": scale,
                       "tol": rtol * scale})
        if e > rtol * scale:
            raise AssertionError(f"{name} K={K} {label}: max |kernel - {twin}| = {e} > "
                                 f"{rtol} * {scale}")
    return checks


def check_kernel(torch, name, K, kern, plain, library, nbytes, flops, peaks, flush, *,
                 D=D_PAPER, tf32_flops=0, arith_twin=None, arith_rtol=TC_RTOL, geometry=None):
    """Parity, run-to-run identity and times of one kernel at one shape.

    ``flops`` are FP32 operations on the CUDA cores and ``tf32_flops`` TF32
    tensor-core operations; the bound is the largest of the bytes' time and
    each kind of operations' time at its own peak, and where the kernel runs
    on the tensor cores the row also keeps the bound of the same work in FP32
    (``bound_ms_fp32``).  ``arith_twin`` is a second twin, of the kernel's own
    arithmetic, held at ``arith_rtol`` (0: bit for bit)."""
    out = kern()
    ref = plain()
    out_t = out if isinstance(out, tuple) else (out,)
    ref_t = ref if isinstance(ref, tuple) else (ref,)
    checks = hold_to_twin(torch, name, K, out_t, ref_t, 0.0 if name in EXACT else RTOL, "twin")
    err = max(c["max_abs_err"] for c in checks) if checks else 0.0
    if arith_twin is not None:
        tw = arith_twin()
        checks += hold_to_twin(torch, name, K, out_t, tw if isinstance(tw, tuple) else (tw,),
                               arith_rtol, "arithmetic twin")
        del tw
    again = kern()
    again_t = again if isinstance(again, tuple) else (again,)
    if not all(torch.equal(a, b) for a, b in zip(out_t, again_t)):
        raise AssertionError(f"{name} K={K}: two launches are not bit-identical")
    terms = {"bytes": nbytes / peaks[0] * 1e3, "fp32": flops / peaks[1] * 1e3,
             "tf32": tf32_flops / peaks[3] * 1e3}
    b_ms = max(terms.values())
    b_by = "bytes" if b_ms == terms["bytes"] else "operations"
    fns = {"ms": kern, "plain_ms": plain}
    if library is not None:
        fns["library_ms"] = library
    row = {
        "name": name, "K": K, "D": D, "max_abs_err": err, "checks": checks,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **{f"bound_ms_{t}": ms for t, ms in terms.items()},
        **time_ms(torch, fns, flush),
    }
    if tf32_flops:
        row["bound_ms_fp32"] = bound_ms(nbytes, flops + tf32_flops / 3, peaks)[0]
    if geometry is not None:
        row["geometry"] = geometry
    print(f"kernel {name:19s} K={K:3d} D={D}: kernel_ms={row['ms']:.4f} plain_ms="
          f"{row['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}"
          + (f"; FP32 {row['bound_ms_fp32']:.4f}" if tf32_flops else "")
          + f") library_ms={row['library_ms']} bit-identical"
          + (f" geometry={geometry}" if geometry is not None else ""))
    for c in checks:
        print(f"  {c['part']:12s} vs {c['twin']:15s} max_abs_err={c['max_abs_err']:.3e} "
              f"tol={c['tol']:.3e} (twin max {c['twin_max_abs']:.3e})")
    return row


def kernel_phase(torch, ops, ref, peaks, lib):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    # bring the clocks up before the first timing
    a = torch.randn((8192, 8192), device=dev)
    for _ in range(20):
        a @ a
    torch.cuda.synchronize()
    del a
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K in KS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + K)
        D = D_PAPER
        U = torch.randn((K, D), generator=gen, device=dev)
        w = torch.randn((D,), generator=gen, device=dev)
        c = torch.rand((K,), generator=gen, device=dev)
        # screening inputs: a benign cluster and 30 % byzantine rows
        base = torch.randn((D,), generator=gen, device=dev)
        Us = base + 0.3 * torch.randn((K, D), generator=gen, device=dev)
        n_bad = (3 * K) // 10
        Us[:n_bad] = base + 20.0 * torch.randn((n_bad, D), generator=gen, device=dev)
        Us = Us.contiguous()
        pn = torch.rand((K,), generator=gen, device=dev) * 100 + 50
        mask0 = torch.ones((K,), dtype=torch.bool, device=dev)
        mask0[-1] = False
        kw = dict(xi0=2.0, delta_xi=0.5, max_rounds=8, ddof=0)
        kd, f = K * D, 4
        rows.append(check_kernel(
            torch, "weighted_sum", K, lambda: ops.weighted_sum(c, U),
            lambda: ref.weighted_sum_ref(U, c), lambda: c @ U,
            (kd + K + D) * f, 2 * kd, peaks, flush))
        rows.append(check_kernel(
            torch, "cosine_sim", K, lambda: ops.cosine_sim(U, w),
            lambda: ref.cosine_sim_ref(U, w), lambda: F.cosine_similarity(U, w[None]),
            (kd + D + K) * f, 4 * kd + 2 * D, peaks, flush,
            geometry=ops.cosine_geometry(K, D, U.data_ptr() | w.data_ptr(), sms)._asdict()))
        rows += gram_checks(torch, ops, ref, K, D, U, Us, pn, mask0, kw, peaks, flush)
        # rank kernels: the masked median's inputs hold multiples of 1/4, so
        # most columns have tied values and the tie-break by client index
        # decides; the trimmed mean takes the normal values, whose sums show
        # the summation order, and is held to its row-order twin bit for bit
        # beside the sort twin.  Operations counted as one per element (a
        # selection needs no more); the masked calls' bytes count the live
        # rows only, the rows the kernel reads
        live = torch.ones((K,), dtype=torch.bool, device=dev)
        live[torch.randperm(K, generator=gen, device=dev)[:DEAD]] = False
        Uq = torch.round(4.0 * U) / 4.0
        rows.append(check_kernel(
            torch, "coord_median", K, lambda: ops.coord_median(U),
            lambda: ref.coord_median_ref(U), lambda: torch.quantile(U, 0.5, dim=0),
            (kd + D) * f, kd, peaks, flush))
        md = (K - DEAD) * D
        # the library's masked median: the dead rows as NaN, which
        # torch.nanquantile skips; K - DEAD live rows is odd, so it selects
        # the middle value, the reference's numpy convention, as the kernel
        Unan = torch.where(live[:, None], Uq, float("nan"))
        if not torch.equal(torch.nanquantile(Unan, 0.5, dim=0), ops.coord_median(Uq, live)):
            raise AssertionError(f"coord_median_masked K={K}: torch.nanquantile differs")
        rows.append(check_kernel(
            torch, "coord_median_masked", K, lambda: ops.coord_median(Uq, live),
            lambda: ref.coord_median_ref(Uq, live), lambda: torch.nanquantile(Unan, 0.5, dim=0),
            (md + D + K) * f, md, peaks, flush))
        rows.append(check_kernel(
            torch, "trimmed_mean", K, lambda: ops.trimmed_mean(U, live, trim=TRIM),
            lambda: ref.trimmed_mean_ref(U, live, trim=TRIM), None,
            (md + D + K) * f, md, peaks, flush,
            arith_twin=lambda: ref.trimmed_mean_rowsum_ref(U, live, trim=TRIM), arith_rtol=0.0))
        for row in rows[-3:]:
            row["geometry"] = ops.rank_geometry(K, D, U.data_ptr(), sms)._asdict()
    # the LoRA adapters' shape, where the Gram kernel takes 16-byte copies
    K, D = GRAM_LORA_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + K)
    U = torch.randn((K, D), generator=gen, device=dev)
    base = torch.randn((D,), generator=gen, device=dev)
    Us = base + 0.3 * torch.randn((K, D), generator=gen, device=dev)
    Us[:2] = base + 20.0 * torch.randn((2, D), generator=gen, device=dev)
    Us = Us.contiguous()
    pn = torch.rand((K,), generator=gen, device=dev) * 100 + 50
    mask0 = torch.ones((K,), dtype=torch.bool, device=dev)
    rows += gram_checks(torch, ops, ref, K, D, U, Us, pn, mask0,
                        dict(xi0=2.0, delta_xi=0.5, max_rounds=8, ddof=0), peaks, flush)
    # the Spambase DNN's D = 10,601 at K = 10, before the grid reads these
    # kernels there: D is odd, so every copy is 4 bytes wide, and the Gram's
    # splits are a few columns long
    K, D = MAIN_K, D_SPAMBASE
    U, _, Us, pn, mask0 = screening_inputs(torch, K, D, 1000 + D)
    rows += gram_checks(torch, ops, ref, K, D, U, Us, pn, mask0,
                        dict(xi0=2.0, delta_xi=0.5, max_rounds=8, ddof=0), peaks, flush)
    kd, f = K * D, 4
    c = pn / pn.sum()
    rows.append(check_kernel(
        torch, "weighted_sum", K, lambda: ops.weighted_sum(c, U),
        lambda: ref.weighted_sum_ref(U, c), lambda: c @ U, (kd + K + D) * f, 2 * kd, peaks,
        flush, D=D))
    live = mask0.clone()
    live[:DEAD] = False
    Uq = torch.round(4.0 * U) / 4.0
    md = int(live.sum()) * D
    rows.append(check_kernel(
        torch, "coord_median_masked", K, lambda: ops.coord_median(Uq, live),
        lambda: ref.coord_median_ref(Uq, live), None, (md + D + K) * f, md, peaks, flush, D=D,
        geometry=ops.rank_geometry(K, D, Uq.data_ptr(), sms)._asdict()))
    gram_edge_checks(torch, ops, ref, lib)
    return rows, one_launch_checks(torch, ops, ref)


def screening_inputs(torch, K, D, seed):
    """U and w of the cosine, and the screening matrix Us (a benign cluster,
    30 % byzantine rows), pn and mask0, on the card from one seed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    U = torch.randn((K, D), generator=gen, device=dev)
    w = torch.randn((D,), generator=gen, device=dev)
    base = torch.randn((D,), generator=gen, device=dev)
    Us = base + 0.3 * torch.randn((K, D), generator=gen, device=dev)
    Us[:(3 * K) // 10] = base + 20.0 * torch.randn(((3 * K) // 10, D), generator=gen, device=dev)
    pn = torch.rand((K,), generator=gen, device=dev) * 100 + 50
    mask0 = torch.ones((K,), dtype=torch.bool, device=dev)
    mask0[-1] = False
    return U, w, Us.contiguous(), pn, mask0


def device_ops(torch, fn, tries: int = 3):
    """The names of the device operations (kernels, copies, fills) of one
    call of ``fn``, traced with ``torch.profiler`` after a warm call.  A
    trace that recorded no device event at all is taken again, up to
    ``tries`` traces: the profiler can miss a whole trace (the first of a
    process, and once in a later one on an H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted((e for e in prof.events()
                                         if e.device_type == DeviceType.CUDA),
                                        key=lambda e: e.time_range.start)]
        if names:
            break
        print(f"device_ops: trace {attempt + 1} recorded no device event; tracing again")
    return names


def one_launch_checks(torch, ops, ref):
    """The device operations of one call of ``cosine_sim``, ``afa_screen`` and
    the three rank wrappers at the main path's K are exactly
    ``DEVICE_OPS_PER_CALL``'s (a profiler trace; the first profiler run of a
    process records none, so one runs first).  For the two one-launch
    reductions, two calls back to back on different inputs, and a call on
    a side stream after one on the current stream, each held to its own
    twin (RTOL per float output, ``good`` and ``rounds`` equal).  Between
    calls the per-stream ticket counter must come back to 0, and two
    streams must not share one.  Returns what was checked."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(xi0=2.0, delta_xi=0.5, max_rounds=8, ddof=0)
    shapes = [(MAIN_K, D_PAPER), GRAM_LORA_SHAPE]
    ins = [screening_inputs(torch, K, D, 4000 + K) for K, D in shapes]
    ins += [screening_inputs(torch, K, D, 5000 + K) for K, D in shapes]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones((1,), device="cuda").sum()
        torch.cuda.synchronize()
    U, w, Us, pn, mask0 = ins[0]
    calls = {"cosine_sim": lambda: ops.cosine_sim(U, w),
             "afa_screen": lambda: ops.afa_screen(Us, pn, mask0, **kw),
             "coord_median": lambda: ops.coord_median(U),
             "coord_median_masked": lambda: ops.coord_median(U, mask0),
             "trimmed_mean": lambda: ops.trimmed_mean(U, mask0, trim=TRIM)}
    report = {"device_ops_per_call": {}, "within_twin": []}
    for name, fn in calls.items():
        names = device_ops(torch, fn)
        want = DEVICE_OPS_PER_CALL[name]
        if len(names) != len(want) or not all(k in n for k, n in zip(want, names)):
            raise AssertionError(f"{name}: one call made the device operations {names}, "
                                 f"expected exactly {want}")
        report["device_ops_per_call"][name] = [n[:90] for n in names]
        print(f"kernel {name:19s} one call = {len(names)} device op(s): "
              + ", ".join(n.split("(")[0][-40:] for n in names))

    def held(label, name, K, out, x):
        U, w, Us, pn, mask0 = x
        twin = (ref.cosine_sim_ref(U, w) if name == "cosine_sim"
                else ref.afa_screen_ref(Us, pn, mask0, **kw))
        out_t = out if isinstance(out, tuple) else (out,)
        checks = hold_to_twin(torch, name, K, out_t,
                              twin if isinstance(twin, tuple) else (twin,), RTOL, "twin")
        report["within_twin"].append({"kernel": name, "K": K, "call": label, "checks": checks})
        print(f"kernel {name:19s} K={K:3d} {label}: within the twin")

    def both(x):
        U, w, Us, pn, mask0 = x
        return ops.cosine_sim(U, w), ops.afa_screen(Us, pn, mask0, **kw)

    # back to back: four calls of each kernel on four inputs, one sync
    outs = [both(x) for x in ins]
    torch.cuda.synchronize()
    for x, (cos, scr), (K, _) in zip(ins, outs, shapes * 2):
        held("back to back", "cosine_sim", K, cos, x)
        held("back to back", "afa_screen", K, scr, x)
    # one call on the current stream, then one on a side stream that does not
    # wait for it, so that the two may run at once
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    first = both(ins[0])
    with torch.cuda.stream(side):
        second = both(ins[2])
    torch.cuda.synchronize()
    for label, x, (cos, scr) in (("current stream", ins[0], first),
                                 ("side stream", ins[2], second)):
        held(label, "cosine_sim", MAIN_K, cos, x)
        held(label, "afa_screen", MAIN_K, scr, x)
    return report


def gram_edge_checks(torch, ops, ref, lib):
    """``gram`` and ``afa_screen`` at ``GRAM_EDGES`` against their twins, as
    ``check_kernel`` holds them (RTOL per part, TC_RTOL against the 3xTF32
    twin, ``good`` and ``rounds`` equal), and reruns bit-identical.  Where U
    starts 4 bytes off, the C entry must also refuse a geometry that the
    operand breaks (wider copies, a tile height it has no kernel for, a
    split that misses the end of D) without launching."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kw = dict(xi0=2.0, delta_xi=0.5, max_rounds=8, ddof=0)
    for K, D, offset in GRAM_EDGES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(3000 + K + D)

        def placed(x):  # a contiguous copy whose data starts `offset` bytes in
            y = torch.empty((x.numel() + 4,), dtype=x.dtype, device=dev)
            y = y[offset // 4:offset // 4 + x.numel()].view(x.shape)
            return y.copy_(x)

        U = placed(torch.randn((K, D), generator=gen, device=dev))
        base = torch.randn((D,), generator=gen, device=dev)
        Us = base + 0.3 * torch.randn((K, D), generator=gen, device=dev)
        Us[:(3 * K) // 10] = base + 20.0 * torch.randn(((3 * K) // 10, D), generator=gen,
                                                       device=dev)
        Us = placed(Us)
        pn = torch.rand((K,), generator=gen, device=dev) * 100 + 50
        mask0 = torch.ones((K,), dtype=torch.bool, device=dev)
        mask0[-1] = K < 3
        geo = ops.gram_geometry(K, D, U.data_ptr(), sms)
        if offset % 8:
            refused = refuses_bad_geometry(torch, lib, U, geo)
            print(f"kernel gram                K={K:3d} D={D} offset={offset}: the C entry "
                  f"refuses {refused}")
        cases = (("gram", lambda: ops.gram(U), (ref.gram_ref(U),), (ref.gram_3xtf32_ref(U),)),
                 ("afa_screen", lambda: ops.afa_screen(Us, pn, mask0, **kw),
                  ref.afa_screen_ref(Us, pn, mask0, **kw),
                  ref.afa_screen_ref(Us, pn, mask0, gram=ref.gram_3xtf32_ref(Us), **kw)))
        for name, kern, exact, arith in cases:
            out = kern()
            out_t = out if isinstance(out, tuple) else (out,)
            checks = (hold_to_twin(torch, name, K, out_t, exact, RTOL, "twin")
                      + hold_to_twin(torch, name, K, out_t, arith, TC_RTOL, "arithmetic twin"))
            again = kern()
            if not all(torch.equal(a, b) for a, b in
                       zip(out_t, again if isinstance(again, tuple) else (again,))):
                raise AssertionError(f"{name} K={K} D={D}: two launches are not bit-identical")
            print(f"kernel {name:19s} K={K:3d} D={D} offset={offset}: width={geo.width} "
                  f"tile_rows={geo.tile_rows} nsplit={geo.nsplit} within twins, bit-identical")
            for c in checks:
                print(f"  {c['part']:12s} vs {c['twin']:15s} max_abs_err={c['max_abs_err']:.3e}"
                      f" ({c['max_abs_err'] / max(c['twin_max_abs'], 1e-30):.2e} of scale)")


def refuses_bad_geometry(torch, lib, U, geo):
    """Call ``repro_gram`` with geometries that break U and expect each one
    refused with a nonzero code; returns their labels."""
    K, D = U.shape
    pg = torch.empty((4 * (geo.nsplit + 1) * geo.entries,), device=U.device)
    g = torch.empty((K, K), device=U.device)
    stream = torch.cuda.current_stream().cuda_stream
    bad = {f"width={w}": geo._replace(width=w) for w in (8, 16, 3)}
    bad["tile_rows=24"] = geo._replace(tile_rows=24)
    bad["nsplit+1"] = geo._replace(nsplit=geo.nsplit + 1)
    bad["chunk-1"] = geo._replace(chunk=geo.chunk - 1)
    for label, b in bad.items():
        rc = lib.repro_gram(U.data_ptr(), pg.data_ptr(), g.data_ptr(), K, D, b.tile_rows,
                            b.nsplit, b.chunk, b.width, stream)
        if rc == 0:
            raise AssertionError(f"repro_gram accepted {label} for U at {U.data_ptr():#x}, "
                                 f"D={D}")
    torch.cuda.synchronize()
    return list(bad)


def rank_edge_inputs(torch, K, D, seed):
    """(K, D) on the CPU from a seed: normal values; an eighth of the columns
    integers in [-2, 2] (ties), an eighth drawn from +-0.0, +-inf and +-1,
    eight columns of one value each, one column all -0.0 and one of +0.0
    and -0.0 mixed."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    u = torch.randn((K, D), generator=gen)
    q = D // 8
    u[:, :q] = torch.randint(-2, 3, (K, q), generator=gen).float()
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 1.0, -1.0])
    u[:, q:2 * q] = specials[torch.randint(0, 6, (K, q), generator=gen)]
    u[:, 2 * q:2 * q + 8] = torch.randn((1, 8), generator=gen)
    u[:, -1] = -0.0
    u[:, -2] = specials[torch.randint(0, 2, (K,), generator=gen)]
    return u


def rank_edge_masks(torch, K, seed):
    """label -> (K,) bool mask: every row live, none, one, ``2 TRIM`` (the
    trimmed mean's empty window) and about half."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    masks = {"all live": torch.ones(K, dtype=torch.bool),
             "all dead": torch.zeros(K, dtype=torch.bool),
             "one live": torch.arange(K) == K // 2}
    masks["m = 2 trim"] = torch.zeros(K, dtype=torch.bool)
    masks["m = 2 trim"][torch.randperm(K, generator=gen)[:2 * TRIM]] = True
    masks["half live"] = torch.rand(K, generator=gen) < 0.5
    return masks


def rank_edge_checks(torch, ops, ref, lib):
    """The rank kernels at ``RANK_EDGE_KS`` x ``RANK_EDGE_LAYOUTS`` and the
    masks of ``rank_edge_masks``: the medians (with each mask, and without
    one) bit-identical to ``ref.coord_median_ref`` and the trimmed mean to
    ``ref.trimmed_mean_rowsum_ref``, the twins run on the CPU (a NaN, from
    +inf and -inf in one sum, matches any NaN: its payload is the
    device's); reruns bit-identical.  A K above ``repro_rank_max_k`` must
    be refused with the ValueError, and the C entry must refuse plans that
    the misaligned view breaks without launching.  Returns what was
    checked."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = []

    def bits(t):
        return t.cpu().contiguous().view(torch.int32)

    def differ(a, b):
        return int(((bits(a) != bits(b)) & ~(a.cpu().isnan() & b.cpu().isnan())).sum())

    for D, offset in RANK_EDGE_LAYOUTS:
        for K in RANK_EDGE_KS:
            u = rank_edge_inputs(torch, K, D, 6000 + K + D)
            buf = torch.empty((K * D + 4,), dtype=torch.float32, device=dev)
            U = buf[offset // 4:offset // 4 + K * D].view(K, D).copy_(u.to(dev))
            geo = ops.rank_geometry(K, D, U.data_ptr(), sms)
            cases = [("coord_median", "no mask", lambda: ops.coord_median(U),
                      ref.coord_median_ref(u))]
            for label, mask in rank_edge_masks(torch, K, 7000 + K).items():
                md = mask.to(dev)
                cases += [
                    ("coord_median_masked", label, lambda md=md: ops.coord_median(U, md),
                     ref.coord_median_ref(u, mask)),
                    ("trimmed_mean", label, lambda md=md: ops.trimmed_mean(U, md, trim=TRIM),
                     ref.trimmed_mean_rowsum_ref(u, mask, trim=TRIM)),
                ]
            for name, label, kern, twin in cases:
                got = kern()
                bad = differ(got, twin)
                if bad:
                    raise AssertionError(f"{name} K={K} D={D} offset={offset} [{label}]: {bad} "
                                         "outputs differ from the twin's bits")
                if not torch.equal(bits(got), bits(kern())):
                    raise AssertionError(f"{name} K={K} D={D} [{label}]: two launches are not "
                                         "bit-identical")
            torch.cuda.synchronize()
            report.append({"K": K, "D": D, "offset": offset, "geometry": geo._asdict(),
                           "cases": [f"{n} [{lab}]" for n, lab, _, _ in cases]})
            print(f"kernel rank K={K:4d} D={D} offset={offset}: bucket={geo.bucket} "
                  f"blocks={geo.blocks} width={geo.width}; {len(cases)} calls bit-identical "
                  "to the twins and on rerun")
            if offset % 8 and K in (31, 200):
                report[-1]["refused"] = refuses_bad_rank_plan(torch, lib, U, geo)
            del U, buf
    max_k = lib.repro_rank_max_k()
    try:
        ops.coord_median(torch.zeros((max_k + 1, 8), device=dev))
    except ValueError as e:
        print(f"kernel rank K={max_k + 1}: refused ({e})")
    else:
        raise AssertionError(f"coord_median accepted K={max_k + 1} > {max_k}")
    return report


def refuses_bad_rank_plan(torch, lib, U, geo):
    """Call ``repro_coord_median`` with plans that break U and expect each one
    refused with a nonzero code; returns their labels."""
    K, D = U.shape
    out = torch.empty((D,), device=U.device)
    stream = torch.cuda.current_stream().cuda_stream
    bad = {f"width={w}": geo._replace(width=w) for w in (8, 16, 3)}
    bad["bucket=16" if geo.bucket != 16 else "bucket=8"] = geo._replace(
        bucket=16 if geo.bucket != 16 else 8)
    bad["blocks+1" if geo.bucket == 0 else "blocks=0"] = geo._replace(
        blocks=geo.blocks + 1 if geo.bucket == 0 else 0)
    for label, b in bad.items():
        rc = lib.repro_coord_median(U.data_ptr(), None, out.data_ptr(), K, D, b.bucket,
                                    b.blocks, b.width, stream)
        if rc == 0:
            raise AssertionError(f"repro_coord_median accepted {label} for U at "
                                 f"{U.data_ptr():#x}, K={K}, D={D}")
    torch.cuda.synchronize()
    print(f"kernel rank K={K:4d} D={D}: the C entry refuses {list(bad)}")
    return list(bad)


def gram_checks(torch, ops, ref, K, D, U, Us, pn, mask0, kw, peaks, flush):
    """``gram`` on U and ``afa_screen`` on the screening inputs Us: each held
    to its exact twin (f32 ``U @ U.T``) at RTOL and to the tensor-core
    arithmetic's twin (``ref.gram_3xtf32_ref``) at TC_RTOL, with its geometry.
    The bound counts the 3K(K+1)D TF32 operations the kernel runs beside the
    bytes; ``bound_ms_fp32`` is the same work's FP32 bound."""
    kd, f = K * D, 4
    props = torch.cuda.get_device_properties(U.device)
    sms = props.multi_processor_count
    geo = ops.gram_geometry(K, D, U.data_ptr(), sms)._asdict()
    # afa_screen reads U twice (the Gram pass, the aggregate pass): from
    # device memory both times where U is larger than L2, else once
    passes = 2 if kd * f > props.L2_cache_size else 1
    return [
        check_kernel(torch, "gram", K, lambda: ops.gram(U), lambda: ref.gram_ref(U),
                     lambda: U @ U.T, (kd + K * K) * f, 0, peaks, flush, D=D,
                     tf32_flops=3 * K * (K + 1) * D,
                     arith_twin=lambda: ref.gram_3xtf32_ref(U), geometry=geo),
        check_kernel(torch, "afa_screen", K, lambda: ops.afa_screen(Us, pn, mask0, **kw),
                     lambda: ref.afa_screen_ref(Us, pn, mask0, **kw), None,
                     (passes * kd + 2 * K + D + 3 * K + 1) * f, 2 * kd, peaks, flush, D=D,
                     tf32_flops=3 * K * (K + 1) * D,
                     arith_twin=lambda: ref.afa_screen_ref(
                         Us, pn, mask0, gram=ref.gram_3xtf32_ref(Us), **kw),
                     geometry=ops.gram_geometry(K, D, Us.data_ptr(), sms)._asdict()),
    ]


def main_path_phase(torch, ops, min_rounds_to_block):
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    data = make_mnist_like()
    n_min = min_rounds_to_block()
    # one untimed round first, so the first route does not pay for library
    # initialisation on the card
    run(None, SimConfig(num_clients=MAIN_K, rounds=1, local_epochs=1), data=data,
        device="cuda")
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    runs = []
    cases = [(label, v, l, True, names) for label, (v, l, names) in ROUTES.items()]
    cases.append(("iterative/plain-torch", "iterative", "fused", False, ()))
    for label, variant, launch, kernels, names in cases:
        sim = SimConfig(**MAIN_SIM)
        server = ServerConfig(num_clients=MAIN_K, afa_variant=variant,
                              kernel_plan=resolve_kernel_plan(kernels, kernel_launch=launch))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run(None, sim, server, data=data, device="cuda")
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        good = [k for k in range(MAIN_K) if k not in set(res.bad_clients.tolist())]
        print(f"main path [{label}]: wall_s={wall:.3f} blocked_round="
              f"{res.blocked_round.tolist()} test_error={[round(e, 3) for e in res.test_error]}")
        print(f"  round_ms={[round(t * 1e3, 3) for t in res.round_times]} "
              f"train_ms/round={res.train_time * 1e3:.3f} agg_ms/round={res.agg_time * 1e3:.3f} "
              f"launches={counts}")
        if list(res.blocked_round[res.bad_clients]) != [n_min] * len(res.bad_clients):
            raise AssertionError(f"{label}: bad clients blocked at "
                                 f"{res.blocked_round[res.bad_clients]}, expected {n_min}")
        if any(res.blocked_round[k] != -1 for k in good):
            raise AssertionError(f"{label}: a good client was blocked: {res.blocked_round}")
        if not res.test_error[-1] < 5.0:
            raise AssertionError(f"{label}: final test error {res.test_error[-1]} % >= 5 %")
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"{label}: kernel {name} was never launched")
        if not kernels and any(counts.values()):
            raise AssertionError(f"{label}: the plain route launched kernels {counts}")
        for name in names:
            launches[name] += counts[name]
        runs.append({
            "route": label, "wall_s": wall, "round_ms": [t * 1e3 for t in res.round_times],
            "train_ms": res.train_time * 1e3, "agg_ms": res.agg_time * 1e3,
            "test_error": res.test_error, "blocked_round": res.blocked_round.tolist(),
            "launches": counts,
        })
    return runs, launches


def baselines_phase(torch, ops):
    """Every baseline rule through ``run`` at the main path's configuration,
    with its gates; returns the runs and the launches of each kernel."""
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    data = make_mnist_like()
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    runs = []
    for (rule, kernels), names in BASELINES.items():
        label = f"{rule}/{'cuda' if kernels else 'plain-torch'}"
        sim = SimConfig(**MAIN_SIM)
        server = ServerConfig(rule=rule, num_clients=MAIN_K,
                              kernel_plan=resolve_kernel_plan(kernels))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run(None, sim, server, data=data, device="cuda")
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        bad = res.bad_clients.tolist()
        picked_bad = [int(g[bad].sum()) for g in res.good_mask_history]
        print(f"baseline [{label}]: wall_s={wall:.3f} test_error="
              f"{[round(e, 3) for e in res.test_error]} byzantine_selected={picked_bad}")
        print(f"  round_ms={[round(t * 1e3, 3) for t in res.round_times]} "
              f"train_ms/round={res.train_time * 1e3:.3f} agg_ms/round={res.agg_time * 1e3:.3f} "
              f"launches={counts}")
        final = res.test_error[-1]
        if rule == "fa":
            if not final > 50.0:
                raise AssertionError(f"{label}: final test error {final} % <= 50 %: the "
                                     "byzantine attack did not reach FA")
        elif not final < 5.0:
            raise AssertionError(f"{label}: final test error {final} % >= 5 %")
        if rule in SELECTING and any(picked_bad):
            raise AssertionError(f"{label}: selected byzantine clients {picked_bad}")
        for name, count in counts.items():
            if (name in names) != (count > 0):
                raise AssertionError(f"{label}: kernel {name} launched {count} times, "
                                     f"expected {'some' if name in names else 'none'}")
            launches[name] += count
        runs.append({
            "rule": rule, "route": "cuda" if kernels else "plain-torch", "wall_s": wall,
            "round_ms": [t * 1e3 for t in res.round_times], "train_ms": res.train_time * 1e3,
            "agg_ms": res.agg_time * 1e3, "test_error": res.test_error,
            "byzantine_selected": picked_bad, "launches": counts,
        })
    return runs, launches


def unmasked_phase(torch, ops):
    """Every rule aggregates one (K, D) matrix through ``dispatch_rule``
    without a participation mask, as the paper's Fig. 3 calls them, on the
    kernel and on the plain route.  The matrix holds 3 byzantine rows (base +
    N(0, 20^2 I)) among benign ones (base + N(0, 0.3^2 I)).  A rule whose
    result involves no decision must give the same aggregate on both routes
    (exactly for comed); afa, mkrum and bulyan decide on distances the two
    routes round differently, so each route must leave out the 3 byzantine
    rows.  Returns the rows and the launches of the kernel-route calls."""
    from repro_torch.core import RULES, AFAConfig, RuleOptions, dispatch_rule

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    K, n_bad = MAIN_K, 3
    base = torch.randn((D_PAPER,), generator=gen, device=dev)
    U = base + 0.3 * torch.randn((K, D_PAPER), generator=gen, device=dev)
    U[:n_bad] = base + 20.0 * torch.randn((n_bad, D_PAPER), generator=gen, device=dev)
    n_k = torch.full((K,), 100.0, device=dev)
    p_k = torch.full((K,), 0.5, device=dev)
    opts = {kern: RuleOptions(use_kernels=kern, afa=AFAConfig(use_kernels=kern))
            for kern in (True, False)}
    ops.reset_launch_counts()
    results = {rule: dispatch_rule(rule, U, n_k, p_k, opts=opts[True]) for rule in sorted(RULES)}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCH_COUNTS)
    if launches["coord_median"] <= 0:
        raise AssertionError(f"unmasked comed did not launch coord_median: {launches}")
    rows = []
    for rule, kres in results.items():
        pres = dispatch_rule(rule, U, n_k, p_k, opts=opts[False])
        for res in (kres, pres):
            if res.aggregate.shape != (D_PAPER,) or not torch.isfinite(res.aggregate).all():
                raise AssertionError(f"unmasked {rule}: aggregate not finite of shape (D,)")
        e = float((kres.aggregate - pres.aggregate).abs().max())
        if rule in ("afa",) + SELECTING:
            for route, res in (("cuda", kres), ("plain", pres)):
                if res.good_mask[:n_bad].any():
                    raise AssertionError(f"unmasked {rule} [{route}]: kept a byzantine row "
                                         f"{res.good_mask.tolist()}")
        else:
            scale = float(pres.aggregate.abs().max())
            if e > (0.0 if rule == "comed" else RTOL) * scale:
                raise AssertionError(f"unmasked {rule}: max |kernel - plain| = {e} "
                                     f"(scale {scale})")
        rows.append({"rule": rule, "K": K, "D": D_PAPER, "max_abs_err": e,
                     "good_mask": kres.good_mask.tolist()})
        print(f"unmasked [{rule}] K={K}: max |kernel - plain|={e:.3e} "
              f"good_mask={kres.good_mask.int().tolist()}")
    return rows, launches


def device_spans(torch, prof, after=None):
    """``(start, end, name)`` of the trace's device operations, sorted, from
    ``after`` (us) on; a named range's device-side annotation is not one."""
    from torch.autograd import DeviceType

    from repro_torch.fed.engine import ROUNDS_RANGE
    from repro_torch.launch.mesh import (
        ALL_REDUCE_RANGE,
        GRID_ALL_GATHER_RANGE,
        GRID_ALL_REDUCE_RANGE,
        GRID_REDUCE_SCATTER_RANGE,
    )

    ranges = (ROUNDS_RANGE, ALL_REDUCE_RANGE, GRID_ALL_REDUCE_RANGE, GRID_ALL_GATHER_RANGE,
              GRID_REDUCE_SCATTER_RANGE)
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.name not in ranges
                  and (after is None or e.time_range.start >= after))


def busy_us(spans) -> float:
    busy, end_us = 0.0, float("-inf")
    for start, end, _ in spans:
        busy += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    return busy


def by_kernel(spans) -> dict:
    """name -> (device us, count) over the spans."""
    out: dict = {}
    for start, end, name in spans:
        total, count = out.get(name, (0.0, 0))
        out[name] = (total + end - start, count + 1)
    return out


def trace(torch, label: str, fn, rounds: int):
    """Run ``fn`` (which returns a dict of the run's own numbers, e.g. train
    and aggregation ms per round) once to warm up, then once under
    ``torch.profiler``: the device's busy share of the wall time and the
    kernels that fill it.  Informational: the launch counts of each path
    come from its phase."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        numbers = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(torch, prof)
    busy = busy_us(spans)
    by_name = by_kernel(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = sorted((n, tc) for n, tc in by_name.items()
                  if any(k in n for k in OUR_KERNEL_NAMES))
    out = {
        "label": label, "rounds": rounds, "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
        "device_events": len(spans), **numbers,
        "top": [{"name": n[:90], "ms": t / 1e3, "count": c} for n, (t, c) in top],
        "ours": [{"name": n[:90], "ms": t / 1e3, "count": c} for n, (t, c) in ours],
    }
    if not spans:
        print(f"profile [{label}]: the profiler recorded no device events (device busy "
              "share not measured)")
        return out
    print(f"profile [{label}, {rounds} rounds]: wall_ms={wall_ms:.3f} device_busy_ms="
          f"{busy / 1e3:.3f} busy_share={busy / 1e3 / wall_ms:.3f} device_events="
          f"{len(spans)} " + " ".join(f"{k}={v:.3f}" for k, v in numbers.items()))
    for item in out["top"]:
        print(f"  {item['ms']:9.3f} ms  x{item['count']:5d}  {item['name']}")
    print("  this repository's kernels on the route:")
    for item in out["ours"]:
        print(f"  {item['ms']:9.3f} ms  x{item['count']:5d}  {item['name']}")
    return out


def profile_phase(torch, data_rounds: int = 3):
    """Trace ``data_rounds`` rounds of the paper DNN's gram/fused route."""
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    data = make_mnist_like()
    sim = SimConfig(num_clients=MAIN_K, bad_frac=0.3, scenario="byzantine",
                    rounds=data_rounds, local_epochs=2, batch_size=200, seed=0)
    server = ServerConfig(num_clients=MAIN_K, afa_variant="gram",
                          kernel_plan=resolve_kernel_plan(True, kernel_launch="fused"))

    def fn():
        res = run(None, sim, server, data=data, device="cuda")
        return {"train_ms": res.train_time * 1e3, "agg_ms": res.agg_time * 1e3}

    return trace(torch, "gram/fused", fn, data_rounds)


def lora_profile_phase(torch, ops):
    """One LoRA run of the gram/fused route (``simulate_llm``: the round
    captured as a CUDA graph, replayed T times) under ``torch.profiler``,
    its counts set to 0 just before: the AFA kernels' calls the whole run
    executed (``graph_run_calls``: the warm-up round's, counted by the
    wrappers, and T replays), the replayed rounds' window from the
    ``fused_rounds`` range's device-side annotation, their device busy
    share, device ms and events a round.  Returns the row and the calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    workload, data = lora_workload_and_data()
    K, T = LORA_SIM["num_clients"], LORA_SIM["rounds"]
    server = ServerConfig(rule="afa", num_clients=K, afa_variant="gram",
                          kernel_plan=resolve_kernel_plan(True, kernel_launch="fused"))
    calls = {"afa_screen": 1}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run(workload, SimConfig(**LORA_SIM), server, data=data, device="cuda",
                  **LORA_EXTRA)
        torch.cuda.synchronize()
    host = dict(ops.LAUNCH_COUNTS)
    executed = graph_run_calls("lora gram/fused", device_spans(torch, prof), host, calls, T)
    row = replay_window_row(torch, prof, "lora gram/fused", calls, T)
    row.update(capture_s=res["capture_time"], calls_executed=executed, host_counts=host,
               replay_ms_per_round=(res["round_times"][0] * T - res["capture_time"]) / T * 1e3)
    return row, executed


def visible_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs the flash kernel's mask leaves visible: causal keys
    kpos <= qpos, aligned top-left."""
    if not causal:
        return lq * lk
    return sum(min(i + 1, lk) for i in range(lq))


def flash_attn_phase(torch, ops, ref, peaks):
    """The two flash-attention kernels against their twins: every
    ``ATTN_SHAPES`` and ``ATTN_ELEMENT_LOADS`` case in f32, bf16 and f16, and
    the main path's shape in all three with times.  f32 goes to
    ``flash_attn`` (3xTF32), bf16/f16 to ``flash_attn_tc``; each is held to
    the exact twin and to the twin of its own arithmetic
    (``flash_attention_3xtf32_ref``, ``flash_attention_tc_ref``).  Returns
    the rows."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    cases = [(shape, causal, dt, False, False)
             for shape, causals in ATTN_SHAPES for causal in causals for dt in dtypes]
    cases += [(shape, causal, dt, misaligned, False)
              for shape, causals, misaligned in ATTN_ELEMENT_LOADS for causal in causals
              for dt in dtypes]
    cases += [(ATTN_MAIN, True, dt, False, True) for dt in dtypes]
    rows = []
    for (B, Lq, Lk, Hq, Hkv, D), causal, dt, misaligned, timed in cases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(2000 + Lq + D)

        def make(*shape):
            x = torch.randn(shape, generator=gen, device=dev).to(dt)
            if not misaligned:
                return x
            y = torch.empty((x.numel() + 1,), dtype=dt, device=dev)[1:].view(shape)
            y.copy_(x)
            return y

        q, k, v = make(B, Lq, Hq, D), make(B, Lk, Hkv, D), make(B, Lk, Hkv, D)
        dname = str(dt).split(".")[-1]
        tc = dt != torch.float32
        name = "flash_attn_tc" if tc else "flash_attn"
        kern = lambda: ops.flash_attention(q, k, v, causal=causal)
        exact = lambda: ref.flash_attention_ref(q, k, v, causal=causal)
        if tc:
            twin = lambda: ref.flash_attention_tc_ref(q, k, v, causal=causal,
                                                      block_k=ops.ATTN_TC_BLOCK_K)
            twin_tol, twin_label = ATTN_TC_ULP[dname], "one output ulp"
        else:
            twin = lambda: ref.flash_attention_3xtf32_ref(q, k, v, causal=causal,
                                                          block_k=ops.ATTN_TC_BLOCK_K)
            twin_tol, twin_label = TF32_ATTN_RTOL, "TF32_ATTN_RTOL"
        out, want = kern(), exact()
        torch.cuda.synchronize()
        tol = ATTN_TOL[dname]
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - tol * want.float().abs()).max())
        label = (f"{name} {dname} {(B, Lq, Lk, Hq, Hkv, D)} causal={causal}"
                 + (" misaligned" if misaligned else ""))
        if not torch.isfinite(out).all() or excess > tol:
            raise AssertionError(f"{label}: max |kernel - twin| = {err}, beyond "
                                 f"atol = rtol = {tol}")
        e_tw = float((out.float() - twin().float()).abs().max())
        tw_tol = twin_tol * float(v.float().abs().max())
        if e_tw > tw_tol:
            raise AssertionError(f"{label}: max |kernel - arithmetic twin| = {e_tw} > "
                                 f"{twin_label} at v's scale {tw_tol}")
        if not torch.equal(out, kern()):
            raise AssertionError(f"{label}: two launches are not bit-identical")
        row = {"name": name, "dtype": dname, "shape": [B, Lq, Lk, Hq, Hkv, D],
               "causal": causal, "misaligned": misaligned, "max_abs_err": err, "tol": tol,
               "max_abs_err_arith_twin": e_tw, "arith_twin_tol": tw_tol,
               "flags": ops.attn_flags(q, k, v, out, causal=causal)}
        # tensor-core operations (three TF32 products per f32 one, at the
        # TF32 rate) and one exponential per visible pair, beside the bytes;
        # for f32 the same work's FP32 bound on the CUDA cores too
        pairs = visible_pairs(Lq, Lk, causal)
        flops = 4 * B * Hq * D * pairs
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        terms = {"bytes": nbytes / peaks[0] * 1e3,
                 "tensor": (flops / peaks[2] if tc else 3 * flops / peaks[3]) * 1e3,
                 "exp": B * Hq * pairs / (peaks[2] * EXP_PER_TENSOR_OP) * 1e3}
        b_ms = max(terms.values())
        b_by = "bytes" if b_ms == terms["bytes"] else "operations"
        row.update({f"bound_ms_{t}": ms for t, ms in terms.items()})
        if not tc:
            row["bound_ms_fp32"] = flops / peaks[1] * 1e3
        row.update(visible_pairs=pairs, flops=flops, bytes=nbytes, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
        if timed:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            fns = {"ms": kern, "plain_ms": twin, "exact_twin_ms": exact,
                   "library_ms": lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=causal, enable_gqa=True)}
            row.update(time_ms(torch, fns, flush))
            print(f"kernel {label}: kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"[bytes {terms['bytes']:.4f}, tensor {terms['tensor']:.4f}, exp "
                  f"{terms['exp']:.4f}" + ("" if tc else f"; FP32 {row['bound_ms_fp32']:.4f}")
                  + f"] exact_twin_ms={row['exact_twin_ms']:.4f} max_abs_err={err:.3e}, vs "
                  f"arithmetic twin {e_tw:.3e} (tol {tw_tol:.3e}) bit-identical")
        else:
            print(f"kernel {label}: max_abs_err={err:.3e} (tol {tol}), vs arithmetic twin "
                  f"{e_tw:.3e} (tol {tw_tol:.3e}) flags={row['flags']} bit-identical")
        rows.append(row)
    return rows


def smollm_forward_inputs(torch):
    """smollm-135m's config, random bf16 weights (seed 0) and B x L tokens
    (seed 1) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = get_config("smollm-135m")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, dev)
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (FWD_B, FWD_L), generator=tgen, device=dev)
    return cfg, params, tokens


def as_f32(cfg, params):
    """smollm-135m's config and weights in f32 (the f32 forwards)."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    return cfg.with_(param_dtype="float32", compute_dtype="float32"), cast(params)


def forward_profile_phase(torch):
    """Trace one bf16 and one f32 forward of smollm-135m on the kernel
    route."""
    from repro_torch.models import build_model

    cfg16, p16, tokens = smollm_forward_inputs(torch)
    traces = []
    for dname, (cfg, params) in (("bf16", (cfg16, p16)), ("f32", as_f32(cfg16, p16))):
        model = build_model(cfg.with_(use_pallas_attention=True))

        def fn():
            with torch.no_grad():
                model.forward(params, {"tokens": tokens})
            return {}

        traces.append(trace(torch, f"smollm-135m {dname} forward, kernel route", fn, 1))
        del model, params
    return traces


def forward_phase(torch, ops):
    """smollm-135m at full width and depth: one B x L forward per route and
    dtype through ``build_model(cfg).forward``; returns the rows and the
    launches of the kernel route (f32 forwards launch ``flash_attn``, bf16
    ones ``flash_attn_tc``, and nothing else)."""
    from repro_torch.models import build_model

    cfg16, p16, tokens = smollm_forward_inputs(torch)
    variants = {"float32": as_f32(cfg16, p16), "bfloat16": (cfg16, p16)}
    rows, launches = [], {"flash_attn": 0, "flash_attn_tc": 0}
    for dname, (cfg, params) in variants.items():
        key = "flash_attn" if dname == "float32" else "flash_attn_tc"
        logits = {}
        for route, pallas in (("kernel", True), ("plain", False)):
            model = build_model(cfg.with_(use_pallas_attention=pallas))
            times, counts = [], []
            with torch.no_grad():
                for _ in range(3):
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    out = model.forward(params, {"tokens": tokens})
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    counts.append(ops.LAUNCH_COUNTS[key])
                    others = {n: c for n, c in ops.LAUNCH_COUNTS.items() if c and n != key}
                    if others:
                        raise AssertionError(f"forward {dname}/{route} launched {others}")
            want = cfg.num_layers if pallas else 0
            if counts != [want] * len(counts):
                raise AssertionError(f"forward {dname}/{route}: {key} launches {counts} "
                                     f"per forward, expected {want}")
            if pallas:
                launches[key] += sum(counts)
            if out.shape != (FWD_B, FWD_L, cfg.vocab_size) or not torch.isfinite(out).all():
                raise AssertionError(f"forward {dname}/{route}: logits not finite of shape "
                                     f"{(FWD_B, FWD_L, cfg.vocab_size)}")
            ms = sorted(times)[len(times) // 2] * 1e3
            logits[route] = out
            rows.append({"dtype": dname, "route": route, "ms": ms,
                         "tokens_per_s": FWD_B * FWD_L / (ms / 1e3),
                         "kernel": key if pallas else None,
                         "launches_per_forward": counts[-1]})
            print(f"forward [{dname}/{route}] smollm-135m {cfg.num_layers} layers "
                  f"B={FWD_B} L={FWD_L}: ms={ms:.2f} tokens/s={FWD_B * FWD_L / (ms / 1e3):.0f} "
                  f"{key} launches/forward={counts[-1]}")
        a, b = logits["kernel"], logits["plain"]
        diff = float((a - b).abs().max())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        rows[-2].update(max_abs_diff=diff, argmax_agreement=agree)
        print(f"forward [{dname}] kernel vs plain: max |logit diff|={diff:.3e} "
              f"argmax agreement={agree:.5f}")
        if dname == "float32":
            excess = float(((a - b).abs() - FWD_TOL * b.abs()).max())
            if excess > FWD_TOL:
                raise AssertionError(f"forward f32: kernel-route logits beyond atol = rtol = "
                                     f"{FWD_TOL} of the plain route's (max diff {diff})")
        del logits, a, b
    return rows, launches


def beyond(torch, a, b, tol) -> float:
    """How far a lies outside ``atol = rtol = tol`` of b (> 0: outside)."""
    return float(((a - b).abs() - tol - tol * b.abs()).max())


def leaves(tree) -> list:
    """The tensors of a tree of dicts and tuples (a cache), in order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def cache_mb(cache, part=None) -> float:
    """MB of a serving cache without its positions, or of one ``part``
    (``"shared"``, or an SSM stack's ``"state"``)."""
    tree = {k: v for k, v in cache.items() if k != "pos"} if part is None else (
        cache["layers"]["state"] if part == "state" else cache[part])
    return sum(t.numel() * t.element_size() for t in leaves(tree)) / 1e6


def same_generation(torch, a, b) -> bool:
    """Two ``generate`` results equal bit for bit: tokens, final logits,
    final cache (every tensor of its tree)."""
    return (torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
            and all(torch.equal(x, y) for x, y in zip(leaves(a.cache), leaves(b.cache))))


def serve_prompts(torch, vocab: int, b: int, p: int, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, vocab, (b, p), generator=gen, device="cuda")


def served(torch, ops, label, model, params, prompts, *, gen, key, launches, want=None,
           patches=None, ring=False):
    """One batch through ``generate`` replayed as a graph and eagerly, after
    one prefill of the same prompts alone: graph = eager bit for bit,
    exactly ``want`` flash launches a prefill (default: L on the kernel
    route, none on the plain one; the eager run's decode steps launch
    eagerly, so a flash call there would show).  A VLM's ``patches`` go
    before the prompts, its linear cache holding them too.  ``ring`` serves
    from the ring cache of the config's window (a windowed prefill, no
    flash launch).  Returns the row,
    the lone prefill's logits, the eager run and the graph's programs."""
    from repro_torch.launch.serve import generate

    cfg = model.config
    b, p = prompts.shape
    if want is None:
        want = cfg.num_layers if cfg.use_pallas_attention else 0
    batch = {"tokens": prompts} if patches is None else {"tokens": prompts,
                                                         "patch_embeds": patches}
    size = p + gen + (0 if patches is None else patches.shape[1])
    if ring:
        size, want = cfg.sliding_window, 0
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_last = model.prefill(params, batch, cache_size=size, use_window=ring)[0]
    torch.cuda.synchronize()
    prefill_s = [time.perf_counter() - t0]
    launches[key] += ops.LAUNCH_COUNTS[key]
    runs, programs = {}, {}
    for mode in ("graph", "eager"):
        ops.reset_launch_counts()
        runs[mode] = generate(model, params, prompts, gen=gen, ring=ring, cache_size=size,
                              graph=mode == "graph",
                              programs=programs if mode == "graph" else None,
                              patch_embeds=patches)
        counts = {n: c for n, c in ops.LAUNCH_COUNTS.items() if c}
        if counts != ({key: want} if want else {}):
            raise AssertionError(f"serve [{label}] {mode}: launches {counts}, expected "
                                 f"{want} {key} in the prefill and none in decode")
        launches[key] += counts.get(key, 0)
    g, e = runs["graph"], runs["eager"]
    if not same_generation(torch, g, e):
        raise AssertionError(f"serve [{label}]: the replayed graph's tokens, logits or cache "
                             "differ from the eager steps'")
    if not torch.isfinite(g.logits).all():
        raise AssertionError(f"serve [{label}]: logits not finite")
    tg, te = g.times, e.times
    steps = tg["decode_steps"]
    # the median of three prefills: the lone one pays the configuration's
    # first use (cuBLAS handles, the allocator's new blocks)
    prefill_ms = sorted(prefill_s + [tg["prefill_s"], te["prefill_s"]])[1] * 1e3
    row = {"label": label, "B": b, "prompt": p, "gen": gen, "ring": ring, "cache_slots": size,
           "prefill_ms": prefill_ms,
           "prefill_ms_first": prefill_s[0] * 1e3, "capture_s": tg["capture_s"],
           "decode_ms_per_token_graph": tg["decode_s"] / steps * 1e3,
           "decode_ms_per_token_eager": te["decode_s"] / steps * 1e3,
           "decode_tokens_per_s_graph": b * steps / tg["decode_s"],
           "tokens_per_s_graph": b * gen / (prefill_ms / 1e3 + tg["decode_s"]),
           "kv_cache_mb": cache_mb(g.cache), "prefill_flash_launches": want}
    if isinstance(g.cache["layers"], dict):
        row["ssm_state_mb"] = cache_mb(g.cache, "state")
    print(f"serve [{label}] B={b} prompt={p} gen={gen} {'ring' if ring else 'linear'} cache of "
          f"{size} slots: prefill_ms={row['prefill_ms']:.2f} "
          f"(first {row['prefill_ms_first']:.2f}) "
          f"decode ms/token graph={row['decode_ms_per_token_graph']:.3f} eager="
          f"{row['decode_ms_per_token_eager']:.3f} capture_s={row['capture_s']:.3f} "
          f"tokens/s={row['tokens_per_s_graph']:.0f} (decode "
          f"{row['decode_tokens_per_s_graph']:.0f}) cache_MB={row['kv_cache_mb']:.1f} "
          + (f"(SSM state {row['ssm_state_mb']:.1f}) " if "ssm_state_mb" in row else "") +
          f"{key} launches/prefill={want}; graph = eager bit for bit")
    return row, logits_last, e, programs


def teacher_forced(torch, ops, label, model, params, prompts, steps, launches, want=None,
                   patches=None):
    """Prefill, then ``steps`` decode steps fed the next tokens, against a
    forward over the whole sequence on the plain attention route, at
    ``SERVE_TF_TOL``; on the kernel route exactly ``want`` flash launches
    (default L), all in the prefill.  A VLM's ``patches`` go first."""
    from repro_torch.models import build_model

    b, p = prompts.shape
    cfg = model.config
    key = "flash_attn" if cfg.cdtype == torch.float32 else "flash_attn_tc"
    extra = serve_prompts(torch, cfg.vocab_size, b, steps, 7)
    plain = build_model(cfg.with_(use_pallas_attention=False))
    batch, at = {"tokens": prompts}, p
    if patches is not None:
        batch["patch_embeds"], at = patches, p + patches.shape[1]
    full = plain.forward(params, dict(batch, tokens=torch.cat([prompts, extra], dim=1)))
    ops.reset_launch_counts()
    lp, cache = model.prefill(params, batch, cache_size=at + steps)
    worst = [beyond(torch, lp, full[:, at - 1], SERVE_TF_TOL[0])]
    diffs = [float((lp - full[:, at - 1]).abs().max())]
    for t in range(steps):
        logits, cache = model.decode_step(params, cache, extra[:, t])
        worst.append(beyond(torch, logits, full[:, at + t], SERVE_TF_TOL[1]))
        diffs.append(float((logits - full[:, at + t]).abs().max()))
    if want is None:
        want = cfg.num_layers if cfg.use_pallas_attention else 0
    counts = {n: c for n, c in ops.LAUNCH_COUNTS.items() if c}
    if counts != ({key: want} if want else {}):
        raise AssertionError(f"serve [{label}]: launches {counts}, expected {want} {key}")
    launches[key] += want
    if max(worst) > 0:
        raise AssertionError(f"serve [{label}]: decode != teacher forcing beyond "
                             f"{SERVE_TF_TOL} (max |diff| per step {diffs})")
    print(f"serve [{label}] decode = teacher forcing: prefill {p} + {steps} steps, max |logit "
          f"diff| prefill={diffs[0]:.3e} steps={max(diffs[1:]):.3e}")
    return {"label": label, "prompt": p, "steps": steps, "max_abs_diff_prefill": diffs[0],
            "max_abs_diff_steps": max(diffs[1:])}


def ring_vs_window(torch, ops, model, params, shape=SERVE_RING):
    """``shape`` (default ``SERVE_RING``): greedy decoding from the ring
    cache (``cache_size`` = the window) against the windowed linear cache
    (``use_window=True``, the prompt and every decoded position in slots),
    logits each step within ``SERVE_TF_TOL[1]``, tokens equal."""
    cfg = model.config
    w, (b, p, gen) = cfg.sliding_window, shape.values()
    prompts = serve_prompts(torch, cfg.vocab_size, b, p, 3)
    out = {}
    ops.reset_launch_counts()
    for name, size, ring in (("ring", w, True), ("window", p + gen, False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompts}, cache_size=size,
                                      use_window=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, steps = [torch.argmax(logits, -1)], []
        for _ in range(gen - 1):
            logits, cache = model.decode_step(params, cache, toks[-1], ring=ring)
            steps.append(logits.clone())
            toks.append(torch.argmax(logits, -1))
        torch.cuda.synchronize()
        out[name] = dict(tokens=torch.stack(toks, 1), logits=steps, mb=cache_mb(cache),
                         prefill_ms=(t1 - t0) * 1e3,
                         decode_ms=(time.perf_counter() - t1) / (gen - 1) * 1e3)
        del cache
    if any(ops.LAUNCH_COUNTS.values()):
        raise AssertionError(f"serve [ring]: the windowed path launched {ops.LAUNCH_COUNTS}")
    r, v = out["ring"], out["window"]
    worst = max(beyond(torch, a, c, SERVE_TF_TOL[1]) for a, c in zip(r["logits"], v["logits"]))
    diff = max(float((a - c).abs().max()) for a, c in zip(r["logits"], v["logits"]))
    if worst > 0 or not torch.equal(r["tokens"], v["tokens"]):
        raise AssertionError(f"serve [ring]: ring decode != window decode past the window "
                             f"(max |logit diff| {diff}, tokens equal "
                             f"{torch.equal(r['tokens'], v['tokens'])})")
    print(f"serve [ring vs window] {cfg.name} f32 B={b} prompt={p} (window {w}, roll "
          f"{p % w}) gen={gen}: max |logit diff|={diff:.3e}, tokens equal; ring cache "
          f"{r['mb']:.1f} MB prefill_ms={r['prefill_ms']:.1f} decode ms/token (eager)="
          f"{r['decode_ms']:.3f}; window cache {v['mb']:.1f} MB prefill_ms="
          f"{v['prefill_ms']:.1f} decode ms/token (eager)={v['decode_ms']:.3f}")
    return {"B": b, "prompt": p, "gen": gen, "window": w, "max_abs_diff": diff,
            **{f"{n}_{k}": out[n][k] for n in out for k in ("mb", "prefill_ms", "decode_ms")}}


def launcher_runs(torch):
    """``repro_torch.launch.serve.main`` as a user runs it: ``SERVE_CLI``,
    then with ``--ring``; rc 0 and the reference's last line."""
    import io

    from repro_torch.launch import serve

    rows = []
    for extra, word in (([], "linear cache"), (["--ring"], "ring cache")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(SERVE_CLI + extra)
        wall = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"  launcher{' --ring' if extra else ''}: {line}")
        if rc != 0 or not lines or not lines[-1].startswith("served ") or word not in lines[-1]:
            raise AssertionError(f"launcher {SERVE_CLI + extra}: rc {rc}, last line "
                                 f"{lines[-1] if lines else None!r}")
        rows.append({"argv": SERVE_CLI + extra, "wall_s": wall, "lines": lines})
    return rows


def serve_llm_phase(torch, ops):
    """LLM serving through ``repro_torch.launch.serve.generate`` and the
    model's prefill / decode_step (phase V): smollm-135m at full width and
    depth on both dtypes and both attention routes, decode = teacher
    forcing, ring = window decode past the window, olmoe-1b-7b in bf16 and
    dropless in f32, the launcher; returns the rows, the traced token and
    the flash launches of the phase."""
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {"flash_attn": 0, "flash_attn_tc": 0}
    rows = {"smollm": []}
    cfg16, p16, _ = smollm_forward_inputs(torch)
    variants = {"bf16": (cfg16, p16), "f32": as_f32(cfg16, p16)}
    b, p, gen = SERVE_LLM.values()
    prompts = serve_prompts(torch, cfg16.vocab_size, b, p, 2)
    traced = None
    with torch.no_grad():
        for dname, (cfg, params) in variants.items():
            key = "flash_attn" if dname == "f32" else "flash_attn_tc"
            last = {}
            for route, pallas in (("kernel", True), ("plain", False)):
                model = build_model(cfg.with_(use_pallas_attention=pallas))
                row, last[route], e, programs = served(
                    torch, ops, f"smollm-135m {dname}/{route}", model, params, prompts, gen=gen,
                    key=key, launches=launches)
                # one eager decode step into the cache's last slot, P + gen - 1
                sync_free_step(torch, model, params, e, f"smollm-135m {dname}/{route}")
                rows["smollm"].append(row)
                if (dname, route) == ("bf16", "kernel"):
                    prog = next(iter(programs.values()))

                    def one_token(prog=prog):
                        prog.cache["pos"].fill_(p)   # the first decoded token's slot
                        prog.run()
                        return {}

                    traced = trace(torch, "smollm-135m bf16 decode token, graph replay",
                                   one_token, 1)
                    del prog
                del e, programs
            diff = float((last["kernel"] - last["plain"]).abs().max())
            rows["smollm"][-2]["logits_last_max_abs_diff_to_plain"] = diff
            print(f"serve [smollm-135m {dname}] logits_last kernel vs plain: max |diff|="
                  f"{diff:.3e}")
            if dname == "f32" and beyond(torch, last["kernel"], last["plain"], FWD_TOL) > 0:
                raise AssertionError(f"serve f32: kernel-route prefill logits beyond atol = "
                                     f"rtol = {FWD_TOL} of the plain route's (max {diff})")
        cfg32, p32 = variants["f32"]
        model = build_model(cfg32.with_(use_pallas_attention=True))
        rows["teacher_forcing"] = [teacher_forced(torch, ops, "smollm-135m f32/kernel", model,
                                                  p32, prompts, SERVE_TF_STEPS, launches)]
        rows["ring"] = ring_vs_window(torch, ops, model, p32)
        del model, variants, p32, p16
        torch.cuda.empty_cache()
        rows["olmoe"] = olmoe_serving(torch, ops, launches)
        rows["teacher_forcing"].append(rows["olmoe"].pop("f32_teacher_forcing"))
    rows["launcher"] = launcher_runs(torch)
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"serve-LLM phase: {rows['phase_s']:.1f} s")
    return rows, traced, launches


def olmoe_serving(torch, ops, launches):
    """olmoe-1b-7b at full width and depth: bf16 served on the kernel route
    (graph = eager, finite logits, memory in use); then, the bf16 copy freed,
    dropless (capacity_factor = E/k) in f32, decode = teacher forcing."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config("olmoe-1b-7b").with_(use_pallas_attention=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    b, p, g = OLMOE_SERVE.values()
    prompts = serve_prompts(torch, cfg.vocab_size, b, p, 4)
    row, *_ = served(torch, ops, "olmoe-1b-7b bf16/kernel", model, params, prompts, gen=g,
                     key="flash_attn_tc", launches=launches)
    row.update(params_b=n_params / 1e9, memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"serve [olmoe-1b-7b bf16] {n_params / 1e9:.3f} B parameters; GPU memory in use "
          f"{row['memory_allocated_gb']:.2f} GB, peak {row['max_memory_allocated_gb']:.2f} GB")
    del params, model
    torch.cuda.empty_cache()
    model = build_model(cfg.with_(param_dtype="float32", compute_dtype="float32",
                                  capacity_factor=cfg.num_experts / cfg.top_k))
    gen.manual_seed(0)
    params = model.init(gen, "cuda")
    b, p, steps = OLMOE_TF.values()
    tf = teacher_forced(torch, ops, "olmoe-1b-7b f32 dropless/kernel", model, params,
                        serve_prompts(torch, cfg.vocab_size, b, p, 5), steps, launches)
    del params, model
    torch.cuda.empty_cache()
    return {"bf16": row, "f32_teacher_forcing": tf}


def family_model(torch, arch: str, **kw):
    """``arch``'s full config (with ``kw``), its model and random weights
    from seed 0 on the card, in the published dtype."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).with_(**kw)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = build_model(cfg)
    return model, model.init(gen, "cuda")


def sync_free_step(torch, model, params, run, label):
    """One eager decode step on a finished run's cache (its last slot)
    under ``torch.cuda.set_sync_debug_mode("error")``: it reads nothing from
    the host."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, run.cache, run.tokens[:, -1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"serve [{label}] an eager decode step ran under sync debug mode 'error'")


def patch_embeds(torch, cfg, b: int, seed: int):
    """A VLM's stubbed SigLIP output: (B, prefix_len, frontend_dim) normals."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randn((b, cfg.prefix_len, cfg.frontend_dim), generator=gen, device="cuda")


def mamba_serving(torch, ops, launches):
    """mamba2-1.3b: bf16 served (``MAMBA_SERVE``, graph = eager bit for bit
    in tokens, logits, state and conv window, no flash launch), an eager
    step without a host sync, one traced replayed token; f32 teacher
    forcing (``FAMILY_TF``)."""
    from repro_torch.models import build_model

    model, params = family_model(torch, "mamba2-1.3b")
    cfg = model.config
    b, p, gen = MAMBA_SERVE.values()
    prompts = serve_prompts(torch, cfg.vocab_size, b, p, 11)
    row, _, e, programs = served(torch, ops, "mamba2-1.3b bf16", model, params, prompts,
                                 gen=gen, key="flash_attn_tc", launches=launches)
    sync_free_step(torch, model, params, e, "mamba2-1.3b bf16")
    prog = next(iter(programs.values()))
    traced = trace(torch, "mamba2-1.3b bf16 decode token, graph replay",
                   lambda: prog.run() or {}, 1)
    del e, programs, prog
    cfg32, p32 = as_f32(cfg, params)
    del params
    b, p, steps = FAMILY_TF.values()
    tf = teacher_forced(torch, ops, "mamba2-1.3b f32", build_model(cfg32), p32,
                        serve_prompts(torch, cfg.vocab_size, b, p, 12), steps, launches)
    return row, tf, traced


def zamba_serving(torch, ops, launches):
    """zamba2-1.2b: bf16 served on the kernel and the plain route
    (``ZAMBA_SERVE``: 6 ``flash_attn_tc`` launches a kernel-route prefill,
    the shared block's, none in decode; graph = eager) and from the ring
    cache (``ZAMBA_RING``, graph = eager); f32 prefills on
    both routes (``logits_last`` within ``FWD_TOL``, 6 ``flash_attn``); f32
    teacher forcing; ring = window past the window (``ZAMBA_RING``)."""
    from repro_torch.models import build_model

    from repro_torch.models.model import hybrid_segments

    model, params = family_model(torch, "zamba2-1.2b")
    cfg = model.config
    nseg = hybrid_segments(cfg)[0]
    b, p, gen = ZAMBA_SERVE.values()
    prompts = serve_prompts(torch, cfg.vocab_size, b, p, 13)
    rows = []
    for route, pallas in (("kernel", True), ("plain", False)):
        m = build_model(cfg.with_(use_pallas_attention=pallas))
        row, _, e, _ = served(torch, ops, f"zamba2-1.2b bf16/{route}", m, params, prompts,
                              gen=gen, key="flash_attn_tc", launches=launches,
                              want=nseg if pallas else 0)
        row["shared_kv_cache_mb"] = cache_mb(e.cache, "shared")
        if pallas:
            sync_free_step(torch, m, params, e, "zamba2-1.2b bf16/kernel")
        rows.append(row)
        del e
    # the ring: the shared blocks' caches of 4,096 slots, decoded past the window
    b, p, gen = ZAMBA_RING.values()
    row, _, e, _ = served(torch, ops, "zamba2-1.2b bf16 ring", m, params,
                          serve_prompts(torch, cfg.vocab_size, b, p, 20), gen=gen,
                          key="flash_attn_tc", launches=launches, ring=True)
    row["shared_kv_cache_mb"] = cache_mb(e.cache, "shared")
    rows.append(row)
    del e, m
    b, p, gen = ZAMBA_SERVE.values()
    cfg32, p32 = as_f32(cfg, params)
    del params
    last = {}
    for route, pallas in (("kernel", True), ("plain", False)):
        ops.reset_launch_counts()
        last[route] = build_model(cfg32.with_(use_pallas_attention=pallas)).prefill(
            p32, {"tokens": prompts}, cache_size=p + gen)[0]
        counts = {n: c for n, c in ops.LAUNCH_COUNTS.items() if c}
        if counts != ({"flash_attn": nseg} if pallas else {}):
            raise AssertionError(f"zamba2-1.2b f32 {route} prefill launched {counts}")
        launches["flash_attn"] += counts.get("flash_attn", 0)
    diff = float((last["kernel"] - last["plain"]).abs().max())
    print(f"serve [zamba2-1.2b f32] logits_last kernel vs plain: max |diff|={diff:.3e}")
    if beyond(torch, last["kernel"], last["plain"], FWD_TOL) > 0:
        raise AssertionError(f"zamba2-1.2b f32: kernel-route prefill logits beyond atol = "
                             f"rtol = {FWD_TOL} of the plain route's (max {diff})")
    rows[0]["f32_logits_last_max_abs_diff_to_plain"] = diff
    model32 = build_model(cfg32.with_(use_pallas_attention=True))
    b, p, steps = FAMILY_TF.values()
    tf = teacher_forced(torch, ops, "zamba2-1.2b f32/kernel", model32, p32,
                        serve_prompts(torch, cfg.vocab_size, b, p, 14), steps, launches,
                        want=nseg)
    ring = ring_vs_window(torch, ops, model32, p32, ZAMBA_RING)
    return rows, tf, ring


def paligemma_serving(torch, ops, launches):
    """paligemma-3b with the kernel asked for: the prefix-LM mask keeps
    every layer on the plain attention (0 flash launches); bf16 served with
    its 256 patches (``PALI_SERVE``, graph = eager), an eager step without
    a host sync; f32 teacher forcing (``PALI_TF``)."""
    from repro_torch.models import build_model

    model, params = family_model(torch, "paligemma-3b", use_pallas_attention=True)
    cfg = model.config
    b, p, gen = PALI_SERVE.values()
    prompts = serve_prompts(torch, cfg.vocab_size, b, p, 15)
    row, _, e, _ = served(torch, ops, "paligemma-3b bf16", model, params, prompts, gen=gen,
                          key="flash_attn_tc", launches=launches, want=0,
                          patches=patch_embeds(torch, cfg, b, 16))
    row["prefix"] = cfg.prefix_len
    sync_free_step(torch, model, params, e, "paligemma-3b bf16")
    del e
    cfg32, p32 = as_f32(cfg, params)
    del params
    b, p, steps = PALI_TF.values()
    tf = teacher_forced(torch, ops, "paligemma-3b f32", build_model(cfg32), p32,
                        serve_prompts(torch, cfg.vocab_size, b, p, 17), steps, launches,
                        want=0, patches=patch_embeds(torch, cfg, b, 18))
    return row, tf


def hubert_forwards(torch, ops, launches):
    """hubert-xlarge, an encoder: forward and loss at ``HUBERT_FWD`` frames
    in bf16 and f32 on both attention routes (48 non-causal flash launches
    a forward on the kernel route, none on the plain one; f32 logits within
    ``FWD_TOL``); a late frame zeroed changes the first frame's logits."""
    from repro_torch.models import build_model

    model, params = family_model(torch, "hubert-xlarge")
    cfg = model.config
    b, l = HUBERT_FWD.values()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    frames = torch.randn((b, l, cfg.frontend_dim), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, l), generator=gen, device="cuda")
    batch = {"frame_embeds": frames, "labels": labels}
    rows, logits = [], {}
    for dname, (c, ps) in (("bf16", (cfg, params)), ("f32", as_f32(cfg, params))):
        key = "flash_attn" if dname == "f32" else "flash_attn_tc"
        for route, pallas in (("kernel", True), ("plain", False)):
            m = build_model(c.with_(use_pallas_attention=pallas))
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                out = m.forward(ps, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts = {n: x for n, x in ops.LAUNCH_COUNTS.items() if x}
                if counts != ({key: cfg.num_layers} if pallas else {}):
                    raise AssertionError(f"hubert-xlarge {dname}/{route}: forward launched "
                                         f"{counts}")
                launches[key] += counts.get(key, 0)
            ops.reset_launch_counts()
            loss, met = m.loss_fn(ps, batch)
            launches[key] += ops.LAUNCH_COUNTS[key]
            if (out.shape != (b, l, cfg.vocab_size) or not torch.isfinite(out).all()
                    or not torch.isfinite(loss)):
                raise AssertionError(f"hubert-xlarge {dname}/{route}: logits or loss not "
                                     "finite of their shapes")
            ms = sorted(times)[1] * 1e3
            logits[(dname, route)] = out
            rows.append({"dtype": dname, "route": route, "ms": ms, "loss": float(loss),
                         "frames_per_s": b * l / (ms / 1e3),
                         "launches_per_forward": cfg.num_layers if pallas else 0})
            print(f"forward [hubert-xlarge {dname}/{route}] B={b} L={l} frames: ms={ms:.2f} "
                  f"frames/s={b * l / (ms / 1e3):.0f} loss={float(loss):.4f} {key} "
                  f"launches/forward={cfg.num_layers if pallas else 0}")
    a, c = logits[("f32", "kernel")], logits[("f32", "plain")]
    diff = float((a - c).abs().max())
    rows[2]["max_abs_diff_to_plain"] = diff
    if beyond(torch, a, c, FWD_TOL) > 0:
        raise AssertionError(f"hubert-xlarge f32: kernel-route logits beyond {FWD_TOL} of the "
                             f"plain route's (max {diff})")
    cfg32, p32 = as_f32(cfg, params)
    late = dict(batch, frame_embeds=frames.clone())
    late["frame_embeds"][:, -1] = 0.0
    ops.reset_launch_counts()
    moved = float((build_model(cfg32.with_(use_pallas_attention=True)).forward(p32, late)[:, 0]
                   - a[:, 0]).abs().max())
    launches["flash_attn"] += ops.LAUNCH_COUNTS["flash_attn"]
    if not moved > 1e-6:
        raise AssertionError(f"hubert-xlarge: zeroing the last frame moved the first frame's "
                             f"logits by {moved}: the encoder is not bidirectional")
    print(f"forward [hubert-xlarge f32] kernel vs plain max |logit diff|={diff:.3e}; the last "
          f"frame zeroed moves the first frame's logits by {moved:.3e}")
    return rows


def families_phase(torch, ops):
    """The SSM, hybrid, VLM and audio families at full width and depth
    (phase Y): mamba2-1.3b, zamba2-1.2b and paligemma-3b served through
    ``generate``, hubert-xlarge's forwards; returns the rows, the traced
    mamba token and the flash launches of the phase."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {"flash_attn": 0, "flash_attn_tc": 0}
    rows = {"teacher_forcing": []}
    with torch.no_grad():
        rows["mamba"], tf, traced = mamba_serving(torch, ops, launches)
        rows["teacher_forcing"].append(tf)
        torch.cuda.empty_cache()
        rows["zamba"], tf, rows["zamba_ring"] = zamba_serving(torch, ops, launches)
        rows["teacher_forcing"].append(tf)
        torch.cuda.empty_cache()
        rows["paligemma"], tf = paligemma_serving(torch, ops, launches)
        rows["teacher_forcing"].append(tf)
        torch.cuda.empty_cache()
        rows["hubert"] = hubert_forwards(torch, ops, launches)
        torch.cuda.empty_cache()
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"families phase: {rows['phase_s']:.1f} s, flash launches {launches}")
    return rows, traced, launches


def lora_run_gates(label, res, K, n_bad, n_min):
    """The LoRA phase's outcome gates on one run."""
    import numpy as np

    rb, err = res["rounds_blocked"], res["test_error"]
    if list(rb[:n_bad]) != [n_min] * n_bad:
        raise AssertionError(f"lora {label}: byzantine clients blocked at {rb[:n_bad]}, "
                             f"expected round {n_min}")
    if (rb[n_bad:] != -1).any() or res["blocked"][:, n_bad:].any():
        raise AssertionError(f"lora {label}: a benign client was blocked: {rb}")
    if (res["good_frac"] > (K - n_bad) / K + 1e-6).any():
        raise AssertionError(f"lora {label}: good_frac {res['good_frac']} above "
                             f"{K - n_bad}/{K}")
    if res["adapter_dim"] != LORA_D or not res["adapter_fraction"] < 0.05:
        raise AssertionError(f"lora {label}: adapter_dim {res['adapter_dim']} (expected "
                             f"{LORA_D}), fraction {res['adapter_fraction']}")
    if not (np.isfinite(err).all() and (err >= 0).all() and (err <= 1).all()):
        raise AssertionError(f"lora {label}: test error {err} not finite in [0, 1]")


def same_lora_run(torch, a, b) -> bool:
    """Two LoRA runs equal bit for bit: test error, good_mask, blocked set,
    blocked rounds and the final adapters."""
    import numpy as np

    from repro_torch.utils.trees import tree_leaves

    return (all(np.array_equal(a[k], b[k])
                for k in ("test_error", "good_mask", "blocked", "rounds_blocked"))
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]["adapters"]),
                                                      tree_leaves(b["params"]["adapters"]))))


def lora_workload_and_data():
    from repro_torch.fed import get_workload, make_llm_fused_data

    workload = get_workload("lora", arch="smollm-135m", reduced=False, rank=4)
    data = make_llm_fused_data(workload.model_cfg, clients=LORA_SIM["num_clients"],
                               seed=LORA_SIM["seed"],
                               samples_per_client=LORA_EXTRA["samples_per_client"],
                               seq=LORA_EXTRA["seq"], n_test=LORA_EXTRA["n_test"])
    return workload, data


def lora_phase(torch, ops, min_rounds_to_block):
    """Federated LoRA fine-tuning of smollm-135m through ``run`` on the AFA
    kernel route and the plain route, each as ``simulate_llm`` runs it (one
    CUDA graph a round, replayed) and as its eager body (``eager=True``:
    ``make_fused_sim``'s ``round_fn`` called once a round), with the gates:
    graph = eager bit for bit; the eager run's wrappers counted their calls
    of T rounds, the graph run's those of its warm-up round (the replays
    are counted from ``lora_profile_phase``'s trace).  Returns the runs, the
    launches of the kernel route's eager run and round ``LORA_DUMP_ROUND``'s
    report, recorded from the eager runs."""
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels import ref
    from repro_torch.kernels.policy import resolve_kernel_plan

    workload, data = lora_workload_and_data()
    K = LORA_SIM["num_clients"]
    T = LORA_SIM["rounds"]
    n_bad = int(round(LORA_SIM["bad_frac"] * K))
    n_min = min_rounds_to_block()
    routes = {"gram/fused": (resolve_kernel_plan(True, kernel_launch="fused"), ("afa_screen",)),
              "gram/plain-torch": (resolve_kernel_plan(False), ())}
    runs, launches, decisions, dumps = [], {}, {}, {}
    for label, (plan, names) in routes.items():
        server = ServerConfig(rule="afa", num_clients=K, afa_variant="gram", kernel_plan=plan)
        dumps[label] = {}
        results = {}
        for engine in ("eager", "graph"):
            eager = engine == "eager"
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with (recording_server_step(torch, dumps[label]) if eager
                  else contextlib.nullcontext()):
                res = run(workload, SimConfig(**LORA_SIM), server, data=data, device="cuda",
                          eager=eager, **LORA_EXTRA)
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCH_COUNTS)
            results[engine] = res
            rb, err = res["rounds_blocked"], res["test_error"]
            replay_ms = (res["round_times"][0] * T - res["capture_time"]) / T * 1e3
            print(f"lora [{label}, {engine}]: wall_s={wall:.3f} capture_s="
                  f"{res['capture_time']:.3f} ms/round without capture={replay_ms:.3f} "
                  f"rounds_blocked={rb.tolist()} good_frac="
                  f"{[round(float(g), 4) for g in res['good_frac']]} test_error="
                  f"{[round(float(e), 4) for e in err]} adapter_dim={res['adapter_dim']} "
                  f"adapter_fraction={res['adapter_fraction']:.5f} launches={counts}")
            lora_run_gates(f"{label}, {engine}", res, K, n_bad, n_min)
            host_rounds = T if eager else 1
            want = {name: host_rounds if name in names else 0 for name in counts}
            if counts != want:
                raise AssertionError(f"lora {label} [{engine}]: wrapper counts {counts}, "
                                     f"expected {want} ({host_rounds} rounds from the host)")
            if names and eager:
                launches = counts
            runs.append({
                "route": label, "engine": engine, "wall_s": wall,
                "capture_s": res["capture_time"], "replay_ms_per_round": replay_ms,
                "test_error": err.tolist(), "good_frac": res["good_frac"].tolist(),
                "rounds_blocked": rb.tolist(), "adapter_dim": res["adapter_dim"],
                "param_dim": res["param_dim"], "adapter_fraction": res["adapter_fraction"],
                "launches": counts,
            })
        if not same_lora_run(torch, results["graph"], results["eager"]):
            raise AssertionError(f"lora {label}: the graph's run differs from the eager body's")
        print(f"lora [{label}]: graph = eager bit for bit (test error, good_mask, blocked, "
              "final adapters)")
        res = results["graph"]
        decisions[label] = (res["rounds_blocked"].tolist(), res["blocked"].tolist())
    first, *rest = decisions.values()
    if any(d != first for d in rest):
        raise AssertionError(f"lora: the routes' blocking decisions differ: {decisions}")
    dump = lora_round_dump(torch, ops, ref, dumps)
    return runs, launches, dump


@contextlib.contextmanager
def recording_server_step(torch, dump: dict, rounds=(LORA_DUMP_ROUND - 1,)):
    """Swap ``server_step`` for a wrapper that keeps the inputs of each of
    ``rounds`` (0-indexed) in ``dump[round]``: the proposals (a packed (K, D)
    matrix or a stacked tree), ``n_k``, the participation mask, the
    reputation means ``p_good`` and the server state.  ``FedServer`` reads
    it from ``repro_torch.fed.server`` and the fused round body from
    ``repro_torch.fed.engine``, so the wrapper is set in both.  It reads the
    round counter on the host, so it records eager rounds only: a CUDA
    graph's replays do not call it."""
    from repro_torch.core import p_good
    from repro_torch.fed import engine as engine_mod
    from repro_torch.fed import server as server_mod
    from repro_torch.utils.trees import tree_map

    real = server_mod.server_step

    def step(state, proposals, n_k, mask0, **kw):
        rnd = int(state.round)
        if rnd in rounds:
            dump[rnd] = dict(
                proposals=tree_map(lambda l: l.detach().float().clone(), proposals),
                n_k=torch.as_tensor(n_k, dtype=torch.float32).clone(),
                mask0=torch.as_tensor(mask0).bool().clone(),
                p_good=p_good(state.reputation).float().clone(), state=state)
        return real(state, proposals, n_k, mask0, **kw)

    server_mod.server_step = engine_mod.server_step = step
    try:
        yield
    finally:
        server_mod.server_step = engine_mod.server_step = real


def lora_round_dump(torch, ops, ref, dumps):
    """ROADMAP C.6, a threshold tie: the inputs of round ``LORA_DUMP_ROUND``
    as each LoRA route saw them (failing if a route recorded none).  The
    first route's go to ``chiprun_out/lora_round{n}_<route>.npz``, which
    ``tools/afa_dump_jax.py`` screens in float64 and with the JAX package.
    On them, the first screening pass's f32 statistics from
    ``ref.afa_screen_ref`` give each live client's signed margin to the tail
    threshold ``median -/+ xi0 sigma`` (negative: screened out), on the
    kernel's Gram and on ``U @ U.T``."""
    import numpy as np

    missing = [label for label, d in dumps.items() if LORA_DUMP_ROUND - 1 not in d]
    if missing:
        raise AssertionError(f"lora: round {LORA_DUMP_ROUND}'s server_step inputs were not "
                             f"recorded on {missing}")
    (label, d), *others = ((label, d[LORA_DUMP_ROUND - 1]) for label, d in dumps.items())
    U, dev = d["proposals"], d["proposals"].device
    n_k, mask0, p = d["n_k"].to(dev), d["mask0"].to(dev), d["p_good"].to(dev)
    name = f"lora_round{LORA_DUMP_ROUND}_{label.replace('/', '_')}.npz"
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    np.savez(out_dir / name, proposals=U.cpu().numpy(), n_k=n_k.cpu().numpy(),
             mask0=mask0.cpu().numpy(), p_good=p.cpu().numpy())
    report = {"round": LORA_DUMP_ROUND, "file": name, "mask0": mask0.tolist(),
              "p_good": p.tolist(), "n_k": n_k.tolist(), "max_abs_proposal": float(U.abs().max()),
              "max_abs_diff_from": {o: float((od["proposals"] - U).abs().max())
                                    for o, od in others}}
    print(f"lora round {LORA_DUMP_ROUND} [{label} inputs, {name}]: mask0="
          f"{mask0.int().tolist()} p_good={[round(x, 5) for x in p.tolist()]}; the other "
          f"routes' proposals differ by {report['max_abs_diff_from']} at most")
    xi0 = 2.0  # ServerConfig's default
    pn = p * n_k
    for gname, G in (("kernel gram", ops.gram(U)), ("plain gram", U @ U.T)):
        s = ref.afa_screen_ref(U, pn, mask0, xi0=xi0, delta_xi=0.5, max_rounds=0, gram=G)[3]
        mean, median = ref._masked_mean(s, mask0), ref.masked_median_cc(s, mask0)
        sigma = ref._masked_std(s, mask0, 0)
        low = bool(mean < median)
        thr = median - xi0 * sigma if low else median + xi0 * sigma
        margin = (s - thr) if low else (thr - s)
        live = mask0.nonzero().flatten().tolist()
        report[gname] = {"tail": "low" if low else "high", "threshold": float(thr),
                         "sims": s.tolist(), "margin": margin.tolist()}
        print(f"  f32 {gname} pass 1: tail={'low' if low else 'high'} "
              f"threshold={float(thr):.9g} " + " ".join(
                  f"k{k}: s={float(s[k]):.9g} margin={float(margin[k]):+.3e}" for k in live))
    return report


def fused_server_cfg(route):
    from repro_torch.fed import ServerConfig
    from repro_torch.kernels.policy import resolve_kernel_plan

    rule, variant, launch, kernels, _ = FUSED_ROUTES[route]
    return ServerConfig(rule=rule, num_clients=MAIN_K, afa_variant=variant,
                        kernel_plan=resolve_kernel_plan(kernels, kernel_launch=launch))


def same_trajectory(a, b, *, error=True) -> bool:
    import numpy as np

    return ((not error or list(a.test_error) == list(b.test_error))
            and np.array_equal(np.stack(a.good_mask_history), np.stack(b.good_mask_history))
            and np.array_equal(a.blocked_round, b.blocked_round))


def fused_run_gates(label, rule, res, n_min):
    """The main path's outcome gates on one fused run: AFA blocks every
    byzantine client in round ``n_min`` and no good one; every robust rule
    ends below 5 % test error."""
    if rule == "afa":
        good = [k for k in range(MAIN_K) if k not in set(res.bad_clients.tolist())]
        if list(res.blocked_round[res.bad_clients]) != [n_min] * len(res.bad_clients):
            raise AssertionError(f"fused {label}: bad clients blocked at "
                                 f"{res.blocked_round[res.bad_clients]}, expected {n_min}")
        if any(res.blocked_round[k] != -1 for k in good):
            raise AssertionError(f"fused {label}: a good client was blocked: "
                                 f"{res.blocked_round}")
    if not res.test_error[-1] < 5.0:
        raise AssertionError(f"fused {label}: final test error {res.test_error[-1]} % >= 5 %")


def fused_phase(torch, ops, min_rounds_to_block):
    """``MAIN_SIM`` through ``run`` with ``engine="fused"`` (the round as one
    CUDA graph, replayed) and ``"fused_eager"`` (the same body called once a
    round) on every route of ``FUSED_ROUTES``, and the ``FUSED_SEGMENT``
    route segmented with compaction.  Gates: graph = eager bit for bit (test
    error, good_mask history, blocked rounds); the outcome gates of the main
    path; segmented = one-shot on the blocked rounds and the good_mask
    history; each wrapper counted exactly the calls of the rounds launched
    from the host: T on the eager body, the warm-up round's on the graph
    engine (the recording launches nothing; the replays are counted from
    ``fused_trace_phase``'s traces), one warm-up a bucket when segmented.
    Returns the runs, the eager runs' launches and each run's result by
    (route, engine)."""
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import SimConfig, run

    data = make_mnist_like()
    n_min = min_rounds_to_block()
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    runs, results = [], {}
    for label, (rule, *_, calls) in FUSED_ROUTES.items():
        server = fused_server_cfg(label)
        for engine in ("fused_eager", "fused"):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = run(None, SimConfig(**MAIN_SIM, engine=engine), server, data=data,
                      device="cuda")
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCH_COUNTS)
            results[(label, engine)] = res
            T = len(res.round_times)
            replay_ms = (res.round_time * T - res.capture_time) / T * 1e3
            print(f"fused [{label}, {engine}]: wall_s={wall:.3f} capture_s="
                  f"{res.capture_time:.3f} round_ms={res.round_time * 1e3:.3f} "
                  f"ms/round without capture={replay_ms:.3f} blocked_round="
                  f"{res.blocked_round.tolist()} test_error="
                  f"{[round(e, 3) for e in res.test_error]} launches={counts}")
            fused_run_gates(f"{label}, {engine}", rule, res, n_min)
            host_rounds = T if engine == "fused_eager" else 1
            want = {name: calls.get(name, 0) * host_rounds for name in counts}
            if counts != want:
                raise AssertionError(f"fused {label} [{engine}]: wrapper counts {counts}, "
                                     f"expected {want} ({host_rounds} rounds from the host)")
            if engine == "fused_eager":
                for name, count in counts.items():
                    launches[name] += count
            runs.append({"route": label, "engine": engine, "wall_s": wall,
                         "capture_s": res.capture_time, "round_ms": res.round_time * 1e3,
                         "replay_ms_per_round": replay_ms, "test_error": res.test_error,
                         "blocked_round": res.blocked_round.tolist(), "launches": counts})
        if not same_trajectory(results[(label, "fused")], results[(label, "fused_eager")]):
            raise AssertionError(f"fused {label}: the graph's trajectory differs from the "
                                 "eager body's")
        print(f"fused [{label}]: graph = eager bit for bit")
    label, seg = FUSED_SEGMENT
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(None, SimConfig(**MAIN_SIM, engine="fused", segment_rounds=seg, compact=True),
              fused_server_cfg(label), data=data, device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCH_COUNTS)
    # two buckets, so two warm-up rounds: 10 rows, then 8 once the three
    # byzantine clients are blocked
    want = {name: 2 * FUSED_ROUTES[label][-1].get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"fused {label}, segmented: wrapper counts {counts}, expected "
                             f"{want} (a warm-up round in each of two buckets)")
    print(f"fused [{label}, segment_rounds={seg}, compact]: wall_s={wall:.3f} capture_s="
          f"{res.capture_time:.3f} round_ms={res.round_time * 1e3:.3f} blocked_round="
          f"{res.blocked_round.tolist()} test_error={[round(e, 3) for e in res.test_error]}")
    fused_run_gates(f"{label}, segmented", "afa", res, n_min)
    one_shot = results[(label, "fused")]
    if not same_trajectory(res, one_shot, error=False):
        raise AssertionError(f"fused {label}: segmented with compaction differs from the "
                             "one-shot run in blocked rounds or good_mask history")
    bit_equal = list(res.test_error) == list(one_shot.test_error)
    print(f"fused [{label}]: segmented = one-shot (blocked rounds, good_mask); test error "
          f"bit for bit: {bit_equal}")
    runs.append({"route": label, "engine": f"fused, segment_rounds={seg}, compact",
                 "wall_s": wall, "capture_s": res.capture_time,
                 "round_ms": res.round_time * 1e3, "test_error": res.test_error,
                 "test_error_equals_one_shot": bit_equal,
                 "blocked_round": res.blocked_round.tolist(), "launches": counts})
    return runs, launches, results


def sweep_phase(torch, ops, fused_results, min_rounds_to_block):
    """``MAIN_SIM`` through ``run(..., seeds=SWEEP_SEEDS)`` on each of
    ``SWEEP_ROUTES``, and on the first segmented with compaction, each sweep
    with its counts set to 0 just before.  Gates: the row of MAIN_SIM's
    seed equals the route's ``engine="fused"`` run of the fused phase bit for
    bit (test error, good_mask history, blocked rounds); the segmented sweep
    equals the unsegmented one bit for bit; every seed blocks each
    byzantine client in round ``min_rounds_to_block()``; the wrappers
    counted the warm-up round of each capture, one a sweep (one a bucket
    segmented: 10 rows, then 8).  Returns the rows and those launches."""
    import numpy as np

    from repro_torch.data import make_mnist_like
    from repro_torch.fed import SimConfig, run

    data = make_mnist_like()
    n_min = min_rounds_to_block()
    at = SWEEP_SEEDS.index(MAIN_SIM["seed"])
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    rows, sweeps = [], {}
    for label, seg in [(r, 0) for r in SWEEP_ROUTES] + [(SWEEP_ROUTES[0], SWEEP_SEGMENT)]:
        calls = FUSED_ROUTES[label][-1]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sw = run(None, SimConfig(**MAIN_SIM, engine="fused", segment_rounds=seg),
                 fused_server_cfg(label), data=data, seeds=SWEEP_SEEDS, device="cuda")
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        name = f"{label}{f', segment_rounds={seg}, compact' if seg else ''}"
        sweeps[name] = sw
        print(f"sweep [{name}]: seeds={list(SWEEP_SEEDS)} wall_s={wall:.3f} capture_s="
              f"{sw.capture_time:.3f} launches={counts}")
        for i, s in enumerate(SWEEP_SEEDS):
            print(f"  seed {s}: detection_rate={sw.detection_rate[i]:.3f} "
                  f"mean_rounds_to_block={sw.mean_rounds_to_block[i]:.3f} blocked_round="
                  f"{sw.blocked_round[i].tolist()} test_error="
                  f"{[round(float(e), 3) for e in sw.test_error[i]]}")
        bad = sw.bad_clients
        if not (sw.blocked_round[:, bad] == n_min).all():
            raise AssertionError(f"sweep [{name}]: byzantine clients blocked at "
                                 f"{sw.blocked_round[:, bad].tolist()}, expected round {n_min}")
        buckets = 2 if seg else 1
        want = {k: buckets * calls.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"sweep [{name}]: wrapper counts {counts}, expected {want} "
                                 f"(a warm-up round a capture, {buckets} captures)")
        for k, n in counts.items():
            launches[k] += n
        if seg:
            base = sweeps[label]
            same = all(np.array_equal(getattr(sw, f), getattr(base, f))
                       for f in ("test_error", "good_mask_history", "blocked_round"))
            if not same:
                raise AssertionError(f"sweep [{name}]: differs from the unsegmented sweep")
            print(f"sweep [{name}]: = the unsegmented sweep bit for bit")
        else:
            one = fused_results[(label, "fused")]
            if not (list(sw.test_error[at]) == list(one.test_error)
                    and np.array_equal(sw.good_mask_history[at], np.stack(one.good_mask_history))
                    and np.array_equal(sw.blocked_round[at], one.blocked_round)):
                raise AssertionError(f"sweep [{name}]: the row of seed {MAIN_SIM['seed']} "
                                     "differs from the engine=\"fused\" run")
            print(f"sweep [{name}]: the row of seed {MAIN_SIM['seed']} = engine=\"fused\" "
                  "bit for bit")
        rows.append({"route": name, "seeds": list(SWEEP_SEEDS), "wall_s": wall,
                     "capture_s": sw.capture_time,
                     "detection_rate": sw.detection_rate.tolist(),
                     "mean_rounds_to_block": sw.mean_rounds_to_block.tolist(),
                     "blocked_round": sw.blocked_round.tolist(),
                     "test_error": sw.test_error.tolist(), "launches": counts})
    return rows, launches


def fused_sync_free_round(torch):
    """One eager round of the fused body on each route under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that waits for
    the card raises."""
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import (SimConfig, fused_inputs, fused_server_state, make_fused_sim,
                                 make_rule_options)

    data = make_mnist_like()
    sim = SimConfig(**MAIN_SIM, engine="fused_eager")
    inp = fused_inputs(data, sim, device="cuda")
    dev = torch.device("cuda")
    for label in FUSED_ROUTES:
        server = fused_server_cfg(label)
        _, round_fn = make_fused_sim(
            inp.workload, inp.engine_cfg, rule=server.rule,
            opts=make_rule_options(server, MAIN_K), delta_block=server.delta_block,
            num_clients=MAIN_K, num_rounds=sim.rounds, batch_s=inp.batch_s,
            batch_b=inp.batch_b, bad_mask=inp.bad_mask, device=dev)
        carry = (inp.params0, fused_server_state(MAIN_K, server.alpha0, server.beta0, dev))
        seed = torch.full((), sim.seed, dtype=torch.int64, device=dev)
        for rnd in range(2):   # the second round runs with everything warm
            r = torch.full((), rnd, dtype=torch.int64, device=dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if rnd else "default")
            try:
                carry, out = round_fn(carry, r, seed, inp.data)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"fused [{label}]: an eager round ran under sync debug mode 'error' "
              f"(test error {float(out.test_error):.4f})")


def keyed_stream_check(torch):
    """Round 5's keyed draws of the main configuration on the card against
    the CPU's: the minibatch words and indices, the dropout bits and the
    noise words bit for bit, the normals within ``KEYED_NORMAL_ATOL``."""
    from repro_torch.attacks.attacks import _ATTACK_STREAM
    from repro_torch.fed.engine import _BATCH_STREAM
    from repro_torch.fed.workload import _DROPOUT_STREAM
    from repro_torch.utils.philox import keyed_bits, keyed_normal, keyed_randint, keyed_words

    S, b, rnd = 10, 200, 5
    out = {}
    for dev in ("cuda", "cpu"):
        offsets = rnd * MAIN_K + torch.arange(MAIN_K, dtype=torch.int64, device=dev)
        seed = torch.full((), MAIN_SIM["seed"], dtype=torch.int64, device=dev)
        lengths = torch.full((MAIN_K,), 1000, dtype=torch.int64, device=dev)
        out[dev] = {
            "batch_words": keyed_words(seed, _BATCH_STREAM, offsets, S * b),
            "batch_idx": keyed_randint(seed, _BATCH_STREAM, offsets, S * b, lengths),
            "dropout_bits": keyed_bits(seed, _DROPOUT_STREAM, offsets, S * b * (512 + 256)),
            "noise_words": keyed_words(seed, _ATTACK_STREAM, offsets, D_PAPER),
            "noise": keyed_normal(seed, _ATTACK_STREAM, offsets, D_PAPER),
        }
    row = {}
    for name, card in out["cuda"].items():
        cpu = out["cpu"][name]
        if name == "noise":
            e = float((card.cpu() - cpu).abs().max())
            row["noise_max_abs_diff"] = e
            if not e <= KEYED_NORMAL_ATOL:
                raise AssertionError(f"keyed normals: card and CPU differ by {e}")
        elif not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"keyed stream {name}: the card's draws differ from the CPU's")
        row[name] = list(card.shape)
    print(f"keyed streams, round {rnd}: card = CPU bit for bit on the words, indices and "
          f"bits {row}; normals within {row['noise_max_abs_diff']:.3e}")
    return row


def round_ops(calls: dict) -> dict:
    """The device kernels of one round: each wrapper call's ``CALL_OPS``."""
    ops_ = {}
    for name, n in calls.items():
        for kname in CALL_OPS[name]:
            ops_[kname] = ops_.get(kname, 0) + n
    return ops_


def our_kernels(spans) -> dict:
    """kernel name -> its launches in the spans, this repository's kernels."""
    counts = {}
    for _, _, name in spans:
        for kname in OUR_KERNEL_NAMES:
            if kname in name:
                counts[kname] = counts.get(kname, 0) + 1
    return counts


def graph_run_calls(label, spans, host, calls, T):
    """The wrapper calls that a traced ``engine="fused"`` run executed, read
    from its device kernels (each wrapper's ``CALL_MARK`` over the whole
    run).  Gates: every kernel of the route ran exactly its count a call
    times those calls, and the calls are the warm-up rounds', which the
    wrappers counted on the host (``host``), plus T replayed rounds'."""
    seen = our_kernels(spans)
    executed = {name: seen.get(CALL_MARK[name], 0) for name in calls}
    if seen != round_ops(executed):
        raise AssertionError(f"fused trace [{label}]: kernels {seen}, expected "
                             f"{round_ops(executed)} for the calls {executed}")
    warm = {name: host[name] // n for name, n in calls.items()}
    want = {name: (warm[name] + T) * n for name, n in calls.items()}
    if (executed != want or len(set(warm.values())) > 1
            or any(c for name, c in host.items() if name not in calls)):
        raise AssertionError(f"fused trace [{label}]: calls executed {executed}, wrapper "
                             f"counts {host}: expected {want}")
    return executed


def replay_window_row(torch, prof, label, calls, T):
    """The replayed rounds of a traced graph run: the window starts at the
    ``fused_rounds`` range's device-side annotation, where the trace has one
    (the host range's start can lie a round after the first replayed
    kernel's), else at the host range's; this repository's kernels in it
    exactly ``calls`` a round times T; the device busy share of the window,
    its device events a round and the kernels that take the time."""
    from torch.autograd import DeviceType

    from repro_torch.fed.engine import ROUNDS_RANGE

    window = [e for e in prof.events()
              if e.name == ROUNDS_RANGE and e.device_type == DeviceType.CPU]
    if len(window) != 1:
        raise AssertionError(f"trace [{label}]: {len(window)} '{ROUNDS_RANGE}' ranges")
    on_device = [e.time_range.start for e in prof.events()
                 if e.name == ROUNDS_RANGE and e.device_type == DeviceType.CUDA]
    start = min(on_device) if on_device else window[0].time_range.start
    print(f"trace [{label}]: window from the {'device' if on_device else 'host'} range; "
          f"device start - host start = {(start - window[0].time_range.start) / 1e3:.3f} ms")
    spans = device_spans(torch, prof, after=start)
    if not spans:
        raise AssertionError(f"trace [{label}]: no device events in the rounds")
    wall_ms = (max(e for _, e, _ in spans) - start) / 1e3
    busy_ms = busy_us(spans) / 1e3
    counts = our_kernels(spans)
    want = {k: n * T for k, n in round_ops(calls).items()}
    if counts != want:
        raise AssertionError(f"trace [{label}]: kernels {counts} in {T} rounds, expected {want}")
    top = sorted(by_kernel(spans).items(), key=lambda kv: -kv[1][0])[:12]
    row = {"label": label, "rounds": T, "window_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms, "device_events": len(spans),
           "events_per_round": len(spans) / T, "kernels": counts,
           "top": [{"name": n[:90], "ms": t / 1e3, "count": c} for n, (t, c) in top]}
    print(f"profile [{label}, {T} rounds replayed]: window_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.3f} "
          f"device_events={len(spans)} ({len(spans) / T:.0f} a round) kernels={counts}")
    for item in row["top"]:
        print(f"  {item['ms']:9.3f} ms  x{item['count']:5d}  {item['name']}")
    return row


def fused_trace_phase(torch, ops):
    """One ``engine="fused"`` run of each kernel route under
    ``torch.profiler``, its counts set to 0 just before: over the whole run
    each of the route's kernels runs exactly its count a round times the
    rounds executed, the warm-up round (counted by the wrappers) and T
    replays (``graph_run_calls``); from the start of the replayed rounds
    (the ``fused_rounds`` range, after the capture) exactly T times; the
    rounds' device busy share over that window.  The ``FUSED_SEGMENT`` run,
    traced the same way over the whole run.  Then the batched engine on the
    gram/fused route, traced over the same eight rounds, for its busy share
    beside it.  Returns the rows and the graph runs' executed calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import make_mnist_like
    from repro_torch.fed import SimConfig, run

    data = make_mnist_like()
    T = MAIN_SIM["rounds"]
    rows = []
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    for label, (*_, calls) in FUSED_ROUTES.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = run(None, SimConfig(**MAIN_SIM, engine="fused"), fused_server_cfg(label),
                      data=data, device="cuda")
            torch.cuda.synchronize()
        host = dict(ops.LAUNCH_COUNTS)
        executed = graph_run_calls(label, device_spans(torch, prof), host, calls, T)
        for name, n in executed.items():
            launches[name] += n
        row = replay_window_row(torch, prof, f"fused {label}", calls, T)
        row.update(calls_executed=executed, host_counts=host, capture_s=res.capture_time)
        rows.append(row)
        print(f"  whole run: calls executed {executed}, counted by the wrappers {host}")
    label, seg = FUSED_SEGMENT
    calls = FUSED_ROUTES[label][-1]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(None, SimConfig(**MAIN_SIM, engine="fused", segment_rounds=seg, compact=True),
            fused_server_cfg(label), data=data, device="cuda")
        torch.cuda.synchronize()
    host = dict(ops.LAUNCH_COUNTS)
    executed = graph_run_calls(f"{label}, segmented", device_spans(torch, prof), host, calls, T)
    for name, n in executed.items():
        launches[name] += n
    rows.append({"label": f"fused {label}, segment_rounds={seg}, compact", "rounds": T,
                 "calls_executed": executed, "host_counts": host})
    print(f"profile [fused {label}, segment_rounds={seg}, compact]: calls executed "
          f"{executed}, counted by the wrappers {host}")
    server = fused_server_cfg("gram/fused")

    def batched():
        res = run(None, SimConfig(**MAIN_SIM), server, data=data, device="cuda")
        return {"train_ms": res.train_time * 1e3, "agg_ms": res.agg_time * 1e3,
                "round_ms": res.round_time * 1e3}

    rows.append(trace(torch, "batched gram/fused", batched, T))
    return rows, launches


def gram_bucket_checks(torch, ops):
    """ROADMAP C.8 on the card: the live rows of a 200-row screening buffer
    (rows 80.. live, as after 80 byzantine clients were blocked) and the same
    rows compacted into a 128-row buffer.  With the split planned for the
    run's 200 rows (``plan_rows``), ``gram``'s Gram and ``afa_screen``'s
    outputs on the live rows are equal bit for bit; without the plan the
    Gram is reported, as are the plain route's cuBLAS products ``U @ U.T``
    and ``U @ v`` on the two layouts."""
    (K, B), D = GRAM_BUCKET, D_PAPER
    _, w, Us, pn, _ = screening_inputs(torch, K, D, 21)
    dev = Us.device
    live = torch.arange(K - 120, K, device=dev)
    n = live.shape[0]
    Ub = torch.zeros((B, D), device=dev)
    Ub[:n] = Us[live]
    pnb = torch.zeros((B,), device=dev)
    pnb[:n] = pn[live]
    mask = torch.zeros((K,), dtype=torch.bool, device=dev)
    mask[live] = True
    maskb = torch.zeros((B,), dtype=torch.bool, device=dev)
    maskb[:n] = True
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row = {"K": K, "bucket": B, "live": n, "D": D,
           "nsplit": {f"{r} rows, plan {p}": ops.gram_geometry(r, D, 1 << 20, sms,
                                                               plan_rows=p).nsplit
                      for r, p in ((K, None), (B, None), (B, K))}}

    def differ(a, b):
        return int((a != b).sum())

    for plan in (K, None):
        g = ops.gram(Us, plan_rows=plan)[live][:, live]
        gb = ops.gram(Ub, plan_rows=plan)[:n, :n]
        row[f"gram_entries_differing_plan_{plan}"] = differ(g, gb)
    agg, good, rounds, sims = ops.afa_screen(Us, pn, mask, xi0=2.0, delta_xi=0.5, max_rounds=8,
                                             plan_rows=K)
    aggb, goodb, roundsb, simsb = ops.afa_screen(Ub, pnb, maskb, xi0=2.0, delta_xi=0.5,
                                                 max_rounds=8, plan_rows=K)
    row["afa_screen_differing"] = {
        "agg": differ(agg, aggb), "good": differ(good[live], goodb[:n]),
        "rounds": differ(rounds, roundsb), "sims": differ(sims[live], simsb[:n])}
    row["plain_gram_entries_differing"] = differ((Us @ Us.T)[live][:, live], (Ub @ Ub.T)[:n, :n])
    row["plain_matvec_differing"] = differ((Us @ w)[live], (Ub @ w)[:n])
    torch.cuda.synchronize()
    print(f"C.8 Gram across buckets (live rows of {K} against {B} rows, D = {D}): "
          f"splits {row['nsplit']}; entries differing: gram planned for {K} rows "
          f"{row[f'gram_entries_differing_plan_{K}']}, unplanned "
          f"{row['gram_entries_differing_plan_None']}; afa_screen planned "
          f"{row['afa_screen_differing']}; plain U @ U.T {row['plain_gram_entries_differing']}, "
          f"U @ v {row['plain_matvec_differing']}")
    if row[f"gram_entries_differing_plan_{K}"] or any(row["afa_screen_differing"].values()):
        raise AssertionError(f"C.8: a bucket's Gram differs from the full buffer's with the "
                             f"split planned for {K} rows: {row}")
    return row


def segmented_compaction_phase(torch, ops):
    """ROADMAP C.8 end to end: ``C8_SIM`` (180 clients, 54 byzantine) with
    ``engine="fused"`` in one shot and in 2-round segments with compaction
    (180 rows, then 128 once the 54 are blocked), on each of ``C8_ROUTES``.
    Gates on the gram kernel routes: segmented = one-shot bit for bit in test
    error, good_mask history and blocked rounds; every byzantine client
    blocked and no good one, so the second bucket holds 126 live rows; one
    warm-up round a bucket counted by the wrappers (two buckets).  The plain
    routes' equality is reported.  Then ``C8_SHARE_SIM`` once on gram/fused,
    its blocking and test error reported."""
    import numpy as np

    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    data = make_mnist_like(n_train=1000 * C8_K)
    rows = []
    for label, (variant, launch, kernels, calls) in C8_ROUTES.items():
        server = ServerConfig(num_clients=C8_K, afa_variant=variant,
                              kernel_plan=resolve_kernel_plan(kernels, kernel_launch=launch))
        t0 = time.perf_counter()
        one = run(None, SimConfig(**C8_SIM, engine="fused"), server, data=data, device="cuda")
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        seg = run(None, SimConfig(**C8_SIM, engine="fused", segment_rounds=2), server,
                  data=data, device="cuda")
        t2 = time.perf_counter()
        counts = dict(ops.LAUNCH_COUNTS)
        bad = set(seg.bad_clients.tolist())
        blocked = {k for k in range(C8_K) if seg.blocked_round[k] > 0}
        equal = {"test_error": list(seg.test_error) == list(one.test_error),
                 "good_mask": bool(np.array_equal(np.stack(seg.good_mask_history),
                                                  np.stack(one.good_mask_history))),
                 "blocked_round": bool(np.array_equal(seg.blocked_round, one.blocked_round))}
        row = {"route": label, "one_shot_s": t1 - t0, "segmented_s": t2 - t1,
               "capture_s": seg.capture_time, "equal": equal, "launches": counts,
               "blocked": len(blocked), "byzantine_blocked": len(bad & blocked),
               "blocked_rounds": sorted(set(seg.blocked_round.tolist())),
               "test_error": seg.test_error}
        rows.append(row)
        print(f"C.8 segmented K = {C8_K} -> {C8_BUCKET} rows [{label}]: segmented = one-shot "
              f"{equal}; blocked {len(blocked)} ({len(bad & blocked)} of {len(bad)} byzantine) "
              f"in rounds {row['blocked_rounds']}; test error {[round(e, 3) for e in seg.test_error]}; "
              f"one-shot {t1 - t0:.2f} s, segmented {t2 - t1:.2f} s; wrapper counts {counts}")
        if not kernels:
            continue
        if not all(equal.values()):
            raise AssertionError(f"C.8 [{label}]: segmented differs from the one-shot run: "
                                 f"{equal}")
        if blocked != bad:
            raise AssertionError(f"C.8 [{label}]: blocked {sorted(blocked)}, expected the "
                                 f"{len(bad)} byzantine clients")
        want = {name: 2 * calls.get(name, 0) for name in counts}
        if counts != want:
            raise AssertionError(f"C.8 [{label}]: wrapper counts {counts}, expected {want} "
                                 "(a warm-up round in each of two buckets)")
    variant, launch, kernels, _ = C8_ROUTES["gram/fused"]
    K = C8_SHARE_SIM["num_clients"]
    res = run(None, SimConfig(**C8_SHARE_SIM, engine="fused"),
              ServerConfig(num_clients=K, afa_variant=variant,
                           kernel_plan=resolve_kernel_plan(kernels, kernel_launch=launch)),
              data=mnist_like(1000 * K), device="cuda")
    share = {"route": "gram/fused", "num_clients": K, "byzantine": len(res.bad_clients),
             "blocked": int((res.blocked_round > 0).sum()), "test_error": res.test_error}
    rows.append(share)
    print(f"byzantine share [{K} clients, {share['byzantine']} byzantine, gram/fused]: blocked "
          f"{share['blocked']}; test error {[round(e, 3) for e in res.test_error]} (reported)")
    return rows


@contextlib.contextmanager
def serve_timers(torch):
    """Time the serve tier from outside (it reads no clock): each aggregation
    step and each cohort ``propose``, synchronised, in ms; each ``submit`` in
    us, keyed by its decision ("... fired" when it closed a round)."""
    from repro_torch.serve import pool as pool_mod
    from repro_torch.serve import service as service_mod

    samples = {"agg_ms": [], "propose_ms": [], "submit_us": {}}
    make_step = service_mod._make_agg_step
    make_propose = pool_mod.make_packed_propose_fn
    submit = service_mod.AggregationService.submit

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            samples[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def timed_submit(self, *args, **kw):
        t0 = time.perf_counter()
        out = submit(self, *args, **kw)
        us = (time.perf_counter() - t0) * 1e6
        key = out.decision + (" fired" if out.fired is not None else "")
        samples["submit_us"].setdefault(key, []).append(us)
        return out

    service_mod._make_agg_step = lambda *a: timed(make_step(*a), "agg_ms")
    pool_mod.make_packed_propose_fn = lambda *a: timed(make_propose(*a), "propose_ms")
    service_mod.AggregationService.submit = timed_submit
    try:
        yield samples
    finally:
        service_mod._make_agg_step = make_step
        pool_mod.make_packed_propose_fn = make_propose
        service_mod.AggregationService.submit = submit


def _spread(xs):
    import numpy as np

    xs = np.asarray(xs, np.float64)
    return {"n": int(xs.size), "median": float(np.median(xs)), "min": float(xs.min()),
            "max": float(xs.max())} if xs.size else {"n": 0}


def serve_phase(torch, ops, fused_results, smi, min_rounds_to_block):
    """The serve tier at full width.  Sync replay (``run_serve_replay``, the
    default ServeConfig) of ``MAIN_SIM`` on each of ``SERVE_ROUTES``, held
    bit for bit to the route's ``engine="fused"`` run of the fused phase
    (test error, blocked rounds, good_mask history), with the main path's
    outcome gates, no rejection and every round's trigger "buffer" or
    "flush"; each kernel route launched its kernels, the plain route none.
    Then asynchronous traffic on gram/fused (``SERVE_ASYNC``,
    ``SERVE_TRAFFIC``, ``SERVE_TARGET_ROUNDS``): exactly the byzantine
    clients blocked, at least ``SERVE_REJECT_MIN`` of their reconnects
    turned away, and a second run with the same ingress log, test errors and
    fire times; whether duplicate and stale rejections occurred is reported.
    Readings: ms of each aggregation step and each cohort propose, us of
    each submit by decision, the host-device bytes of a round, the copies'
    times, and the device busy share of 8 traced sync-replay rounds.
    Returns the readings and the phase's wrapper counts."""
    import numpy as np

    from repro_torch.data import make_mnist_like
    from repro_torch.fed import SimConfig, fused_inputs
    from repro_torch.serve import (REJECTED_DUPLICATE, REJECTED_STALE, AggregationService,
                                   ProposalPool, ServeConfig, TrafficConfig, run_serve_replay,
                                   run_traffic)

    data = make_mnist_like()
    sim = SimConfig(**MAIN_SIM)
    n_min = min_rounds_to_block()
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    out = {"nvidia_smi": smi, "replay": [], "async": {}}
    for label in SERVE_ROUTES:
        server = fused_server_cfg(label)
        calls = FUSED_ROUTES[label][-1]
        with serve_timers(torch) as samples:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = run_serve_replay(data, sim, server, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCH_COUNTS)
        ref = fused_results[(label, "fused")]
        fused_run_gates(f"serve replay {label}", "afa", res, n_min)
        if not same_trajectory(res, ref):
            raise AssertionError(f"serve replay [{label}]: differs from engine='fused' "
                                 f"(test error {res.test_error} against {ref.test_error}, "
                                 f"blocked {res.blocked_round} against {ref.blocked_round})")
        triggers = sorted({r.trigger for r in res.rounds})
        if not set(triggers) <= {"buffer", "flush"} or any(
                v for d, v in res.decisions.items() if d != "accepted"):
            raise AssertionError(f"serve replay [{label}]: triggers {triggers}, decisions "
                                 f"{res.decisions}")
        for name in calls:
            if counts[name] <= 0:
                raise AssertionError(f"serve replay [{label}]: kernel {name} was never launched")
        if not calls and any(counts.values()):
            raise AssertionError(f"serve replay [{label}]: the plain route launched {counts}")
        for name, c in counts.items():
            launches[name] += c
        row = {"route": label, "wall_s": wall, "agg_ms": samples["agg_ms"],
               "propose_ms": samples["propose_ms"],
               "submit_us": {k: _spread(v) for k, v in samples["submit_us"].items()},
               "test_error": res.test_error, "blocked_round": res.blocked_round.tolist(),
               "decisions": res.decisions, "launches": counts}
        out["replay"].append(row)
        print(f"serve replay [{label}] ({smi}): = engine='fused' bit for bit; wall_s="
              f"{wall:.3f} agg_ms={[round(t, 3) for t in samples['agg_ms']]} propose_ms="
              f"{[round(t, 3) for t in samples['propose_ms']]} submit_us (median) "
              f"{ {k: round(v['median'], 1) for k, v in row['submit_us'].items()} } "
              f"launches={counts}")

    # asynchronous traffic, twice from the same inputs
    server = fused_server_cfg("gram/fused")
    inputs = fused_inputs(data, sim, device="cuda")
    reps = []
    for attempt in range(2):
        with serve_timers(torch) as samples:
            ops.reset_launch_counts()
            svc = AggregationService(inputs.workload, server, ServeConfig(**SERVE_ASYNC),
                                     inputs.params0, inputs.data)
            t0 = time.perf_counter()
            rep = run_traffic(svc, ProposalPool(inputs, sim.seed), TrafficConfig(**SERVE_TRAFFIC),
                              target_rounds=SERVE_TARGET_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCH_COUNTS)
        reps.append((svc, rep))
        for name, c in counts.items():
            launches[name] += c
        if attempt == 0:
            out["async"] = {
                "wall_s": wall, "rounds": len(rep.rounds), "events": rep.n_events,
                "decisions": rep.decisions, "byz_after_block": rep.byz_submissions_after_block,
                "byz_rejected": rep.byz_rejected_at_ingress,
                "byz_reject_fraction": rep.byz_reject_fraction,
                "triggers": [r.trigger for r in rep.rounds],
                "n_accepted": [r.n_accepted for r in rep.rounds],
                "test_error": [r.test_error for r in rep.rounds],
                "agg_ms": samples["agg_ms"], "propose_ms": samples["propose_ms"],
                "submit_us": {k: _spread(v) for k, v in samples["submit_us"].items()},
                "launches": counts}
    (svc, rep), (svc2, rep2) = reps
    a = out["async"]
    print(f"serve async [gram/fused] ({smi}): {a['rounds']} rounds in {a['events']} events, "
          f"wall_s={a['wall_s']:.3f}; decisions {rep.decisions}; byzantine reconnects after "
          f"blocking {rep.byz_submissions_after_block}, rejected {rep.byz_rejected_at_ingress} "
          f"({rep.byz_reject_fraction:.3f}); triggers {a['triggers']}; agg_ms median "
          f"{_spread(a['agg_ms'])['median']:.3f} propose_ms median "
          f"{_spread(a['propose_ms'])['median']:.3f}; submit_us "
          f"{ {k: round(v['median'], 1) for k, v in a['submit_us'].items()} }; "
          f"launches {a['launches']}")
    if len(rep.rounds) != SERVE_TARGET_ROUNDS:
        raise AssertionError(f"serve async: {len(rep.rounds)} rounds fired")
    if not np.array_equal(svc.blocked, inputs.bad_mask):
        raise AssertionError(f"serve async: blocked {svc.blocked.tolist()}, byzantine "
                             f"{inputs.bad_mask.tolist()}")
    if not (rep.byz_submissions_after_block > 0
            and rep.byz_reject_fraction >= SERVE_REJECT_MIN):
        raise AssertionError(f"serve async: byzantine reconnects rejected "
                             f"{rep.byz_rejected_at_ingress} of "
                             f"{rep.byz_submissions_after_block}")
    if not (svc.log == svc2.log
            and [r.test_error for r in rep.rounds] == [r.test_error for r in rep2.rounds]
            and [r.fired_at for r in rep.rounds] == [r.fired_at for r in rep2.rounds]):
        raise AssertionError("serve async: a second run differs in its ingress log, test "
                             "errors or fire times")
    if a["launches"]["afa_screen"] <= 0:
        raise AssertionError("serve async: afa_screen was never launched")
    for decision in (REJECTED_DUPLICATE, REJECTED_STALE):
        if rep.decisions[decision] == 0:
            print(f"serve async: NOT EXERCISED at K = {MAIN_K}: no {decision} in this "
                  "configuration")
    print("serve async: a second run gave the same ingress log, test errors and fire times")

    # what a sync round moves between host and device, and the copies' times
    K, D = MAIN_K, D_PAPER
    out["bytes_per_round"] = {
        "h2d": {"rows (pinned, one copy)": 4 * K * D, "mask0": K, "versions (int32)": 4 * K,
                "blocked, to the pool": K, "blocking decision from betainc": K},
        "d2h": {"cohort rows (pool, once a version)": 4 * K * D, "blocked": K, "good_mask": K,
                "test error": 4, "all_blocked": 1, "alpha and beta, for betainc": 8 * K},
    }
    pinned = torch.empty((K, D), pin_memory=True)
    on_card = torch.empty((K, D), device="cuda")
    copies = {"h2d_pinned_ms": [], "d2h_pageable_ms": []}
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        copies["h2d_pinned_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        on_card.cpu().numpy()
        copies["d2h_pageable_ms"].append((time.perf_counter() - t0) * 1e3)
    out["copies"] = {k: _spread(v) for k, v in copies.items()}
    print(f"serve copies ({smi}): host-device bytes a sync round "
          f"{ {d: sum(v.values()) for d, v in out['bytes_per_round'].items()} }; (K, D) f32 "
          f"pinned to card {out['copies']['h2d_pinned_ms']['median']:.3f} ms, card to pageable "
          f"host {out['copies']['d2h_pageable_ms']['median']:.3f} ms (median of 10)")

    def replay():
        run_serve_replay(data, sim, server, device="cuda")
        return {}

    out["trace"] = trace(torch, "serve sync replay gram/fused", replay, MAIN_SIM["rounds"])
    return out, launches


def grid_gates(where, res, n_min, scenario, err_max, afa):
    """Tables 1/2's gates on one run: no good client blocked; under clean
    no client blocked; under byzantine and flipping every bad client blocked
    in round ``n_min`` (AFA); AFA's round-8 test error below ``err_max``."""
    bad = set(res.bad_clients.tolist())
    rb = res.blocked_round
    if any(rb[k] != -1 for k in range(len(rb)) if k not in bad):
        raise AssertionError(f"{where}: a good client was blocked: {rb.tolist()}")
    if scenario == "clean" and (rb != -1).any():
        raise AssertionError(f"{where}: a client was blocked on clean data: {rb.tolist()}")
    if afa and scenario in GRID_BLOCKING and list(rb[res.bad_clients]) != [n_min] * len(bad):
        raise AssertionError(f"{where}: bad clients blocked at {rb[res.bad_clients]}, "
                             f"expected round {n_min}")
    if afa and not res.test_error[-1] < err_max:
        raise AssertionError(f"{where}: round-8 test error {res.test_error[-1]} % >= {err_max} %")


def screening_margins(torch, U, pn, mask0, G, client):
    """``client``'s margin to the tail threshold in each pass of Algorithm 1
    on the Gram matrix ``G``, in G's dtype (negative: screened out in that
    pass), until the client is removed or the screen stops; ServerConfig's
    xi0 = 2.0 and delta_xi = 0.5, ddof 0, as ``ref.afa_screen_ref``."""
    u, pn = U.to(G.dtype), pn.to(G.dtype)
    rn = torch.sqrt(torch.clamp((u * u).sum(1), min=1e-12))
    mask, xi, margins = mask0.clone(), 2.0, []
    for _ in range(8):
        c = torch.where(mask, pn, 0.0)
        c = c / c.sum()
        gc = G @ c
        s = gc / (rn * torch.sqrt(torch.clamp(c @ gc, min=1e-12)))
        live = torch.sort(s[mask]).values
        n = live.numel()
        mean, median = live.mean(), 0.5 * (live[(n - 1) // 2] + live[n // 2])
        sd = torch.sqrt(((live - mean) ** 2).mean())
        margin = s - (median - xi * sd) if bool(mean < median) else median + xi * sd - s
        margins.append(float(margin[client]))
        bad = mask & (margin < 0)
        if int((mask & ~bad).sum()) < 2:
            bad[:] = False
        mask, xi = mask & ~bad, xi + 0.5
        if not (bool(mask[client]) and bool(bad.any())):
            break
    return margins


def margins64(torch, U, pn, mask, xi):
    """Every client's float64 margin to the tail threshold in one pass of
    Algorithm 1 that enters with ``mask`` at ``xi`` (negative: screened
    out), ddof 0, as ``ref.afa_screen_ref``."""
    u, pn = U.double(), pn.double()
    rn = torch.sqrt(torch.clamp((u * u).sum(1), min=1e-12))
    c = torch.where(mask, pn, 0.0)
    c = c / c.sum()
    gc = (u @ u.T) @ c
    s = gc / (rn * torch.sqrt(torch.clamp(c @ gc, min=1e-12)))
    live = torch.sort(s[mask]).values
    n = live.numel()
    mean, median = live.mean(), 0.5 * (live[(n - 1) // 2] + live[n // 2])
    sd = torch.sqrt(((live - mean) ** 2).mean())
    return s - (median - xi * sd) if bool(mean < median) else median + xi * sd - s


def screen_mask(ops, side, passes):
    """The good_mask of one screen, ``(route, U, n_k, p_good, mask0)`` with
    route ``"kernel"`` (``afa_screen``) or ``"plain"`` (the plain route's
    gram screen), stopped after ``passes`` passes of Algorithm 1."""
    from repro_torch.core import AFAConfig, afa_aggregate

    route, U, n_k, p, m0 = side
    if passes == 0:
        return m0
    if route == "kernel":
        return ops.afa_screen(U, (p * n_k).contiguous(), m0, xi0=2.0, delta_xi=0.5,
                              max_rounds=passes, ddof=0)[1]
    return afa_aggregate(U, n_k, p, m0, AFAConfig(variant="gram", max_rounds=passes)).good_mask


def first_split(torch, ops, a, b):
    """Two screens (``screen_mask``'s sides) whose good_masks differ: the
    first pass after which their masks differ, the clients they decide apart
    in it, and those clients' float64 margins in that pass on each screen's
    inputs, from the mask both screens entered it with."""
    from repro_torch.core import AFAConfig

    for n in range(AFAConfig().max_rounds + 1):
        ma, mb = screen_mask(ops, a, n), screen_mask(ops, b, n)
        if not torch.equal(ma, mb):
            break
    else:
        raise AssertionError("the two screens' masks never differ")
    if n == 0:
        raise AssertionError("the two screens start from different participation masks")
    enter, xi = screen_mask(ops, a, n - 1), 2.0 + 0.5 * (n - 1)
    clients = (ma != mb).nonzero().flatten().tolist()
    margins = [[float(m) for m in margins64(torch, U, (p * n_k).contiguous(), enter, xi)[clients]]
               for _, U, n_k, p, _ in (a, b)]
    return n, clients, margins


def noisy_route_checks(torch, ops, dname, afa_runs, dumps):
    """The noisy scenario on the AFA kernel route and the plain route
    (``afa_runs``, with every round's ``server_step`` inputs in ``dumps``).
    Same inputs: every round's inputs of each run screened by ``afa_screen``
    and by the plain route's gram screen give the same good_mask, but where
    the two screens' masks first differ, in the pass where they do, every
    client they decide apart has a float64 margin within ``NOISY_TIE`` (a
    tie, which f32 rounding decides).  End to end: the noisy clients each
    route blocked, beside the JAX package's; where the routes' blocked
    rounds differ, the first round whose good_mask differs must split off
    such a tie, the kernel screen on the kernel route's inputs against the
    plain screen on the plain route's, on both inputs.  Each split is
    printed with its clients' margins a pass on the kernel's Gram, on
    ``U @ U.T`` and in float64.  Returns the report."""
    import numpy as np

    from repro_torch.core import AFAConfig
    from repro_torch.utils.trees import pack_stack

    def inputs(label, rnd):
        d = dumps[label][rnd]
        U = pack_stack(d["proposals"])
        return U, d["n_k"].to(U.device), d["p_good"], d["mask0"].to(U.device)

    def margins(U, n_k, p, m0, k):
        pn = (p * n_k).contiguous()
        return {g: screening_margins(torch, U, pn, m0, G, k) for g, G in (
            ("kernel gram", ops.gram(U)), ("U @ U.T", U @ U.T),
            ("float64", U.double() @ U.double().T))}

    def check_split(where, a, b):
        n, clients, m64 = first_split(torch, ops, a, b)
        for i, k in enumerate(clients):
            per_pass = {side[0]: {g: [f"{x:+.3e}" for x in v]
                                  for g, v in margins(*side[1:], k).items()} for side in (a, b)}
            print(f"{where}: the kernel and plain screens decide client {k} apart first in "
                  f"pass {n}, float64 margins there {[f'{m[i]:+.3e}' for m in m64]}; margin a "
                  f"pass on each screen's inputs {per_pass}")
            if any(abs(m[i]) > NOISY_TIE for m in m64):
                raise AssertionError(f"{where}: client {k} decided apart in pass {n} off a tie "
                                     f"(float64 margins {[m[i] for m in m64]} > {NOISY_TIE})")
        return {"pass": n, "clients": clients, "float64_margins": m64}

    (kl, kres), (pl, pres) = afa_runs.items()
    bad = kres.bad_clients.tolist()
    report = {"blocked": {}, "same_input_ties": [], "split": None}
    for label, res in afa_runs.items():
        got = {k: int(res.blocked_round[k]) for k in bad if res.blocked_round[k] > 0}
        report["blocked"][label] = got
        print(f"grid [{dname}, noisy, {label}]: noisy clients blocked {got} (client: round) "
              f"of {len(bad)}; the JAX package's: {JAX_NOISY[dname]}")
    for label in afa_runs:
        for rnd in sorted(dumps[label]):
            x = inputs(label, rnd)
            full = AFAConfig().max_rounds
            if torch.equal(screen_mask(ops, ("kernel", *x), full),
                           screen_mask(ops, ("plain", *x), full)):
                continue
            where = f"grid [{dname}, noisy]: {label}'s round {rnd + 1} inputs"
            report["same_input_ties"].append(
                dict(check_split(where, ("kernel", *x), ("plain", *x)), inputs=label,
                     round=rnd + 1))
    if np.array_equal(kres.blocked_round, pres.blocked_round):
        print(f"grid [{dname}, noisy]: both AFA routes block alike")
        return report
    rnd = next(r for r, (a, b) in enumerate(zip(kres.good_mask_history, pres.good_mask_history))
               if not np.array_equal(a, b))
    where = f"grid [{dname}, noisy]: round {rnd + 1}, {kl} against {pl}"
    report["split"] = dict(check_split(where, ("kernel", *inputs(kl, rnd)),
                                       ("plain", *inputs(pl, rnd))), round=rnd + 1)
    print(f"grid [{dname}, noisy]: the AFA routes block apart ({kres.blocked_round.tolist()} "
          f"against {pres.blocked_round.tolist()}), from a tie in round {rnd + 1}")
    return report


def paper_grid_phase(torch, ops, min_rounds_to_block):
    """Tables 1 and 2 at the published widths (``GRID_DATA``, ``GRID_SIM``):
    every scenario of ``GRID_SCENARIOS`` under every route of ``GRID_ROUTES``
    on the batched engine, with ``grid_gates``, each kernel route launching
    exactly its kernels; on the noisy scenario ``noisy_route_checks``.  Then
    afa gram/fused on ``engine="fused"`` against ``"fused_eager"`` under
    ``GRID_FUSED``: graph = eager bit for bit.  Returns the runs, the noisy
    reports, the launches of the batched and eager runs and the grid's wall
    time."""
    import numpy as np

    from repro_torch.data import make_mnist_like, make_spambase_like
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    n_min = min_rounds_to_block()
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    runs, noisy = [], {}
    t_grid = time.perf_counter()
    for dname, (data_kw, hidden, lr, D, err_max) in GRID_DATA.items():
        data = (make_mnist_like if dname == "mnist" else make_spambase_like)(**data_kw)
        for scenario in GRID_SCENARIOS:
            sim = SimConfig(**GRID_SIM, scenario=scenario, hidden=hidden, lr=lr)
            afa_runs, dumps = {}, {}
            for label, (rule, variant, kernels, names) in GRID_ROUTES.items():
                server = ServerConfig(rule=rule, num_clients=MAIN_K, afa_variant=variant,
                                      kernel_plan=resolve_kernel_plan(kernels))
                where = f"grid [{dname}, {scenario}, {label}]"
                record = rule == "afa" and scenario == "noisy"
                dumps[label] = {}
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                with (recording_server_step(torch, dumps[label], range(GRID_SIM["rounds"]))
                      if record else contextlib.nullcontext()):
                    res = run(None, sim, server, data=data, device="cuda")
                wall = time.perf_counter() - t0
                counts = dict(ops.LAUNCH_COUNTS)
                print(f"{where}: D={D} wall_s={wall:.3f} round_ms="
                      f"{[round(t * 1e3, 2) for t in res.round_times]} blocked_round="
                      f"{res.blocked_round.tolist()} test_error="
                      f"{[round(e, 2) for e in res.test_error]}")
                for name, count in counts.items():
                    if (name in names) != (count > 0):
                        raise AssertionError(f"{where}: kernel {name} launched {count} times, "
                                             f"expected {'some' if name in names else 'none'}")
                    launches[name] += count
                grid_gates(where, res, n_min, scenario, err_max, rule == "afa")
                if rule == "afa":
                    afa_runs[label] = res
                runs.append({"dataset": dname, "D": D, "scenario": scenario, "route": label,
                             "engine": "batched", "wall_s": wall,
                             "round_ms": [t * 1e3 for t in res.round_times],
                             "test_error": res.test_error,
                             "blocked_round": res.blocked_round.tolist(), "launches": counts})
            if scenario == "noisy":
                noisy[dname] = noisy_route_checks(torch, ops, dname, afa_runs, dumps)
        server = ServerConfig(num_clients=MAIN_K, afa_variant="gram",
                              kernel_plan=resolve_kernel_plan(True))
        for scenario in GRID_FUSED:
            results = {}
            for engine in ("fused_eager", "fused"):
                where = f"grid fused [{dname}, {scenario}, {engine}]"
                sim = SimConfig(**GRID_SIM, scenario=scenario, hidden=hidden, lr=lr,
                                engine=engine)
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                res = results[engine] = run(None, sim, server, data=data, device="cuda")
                wall = time.perf_counter() - t0
                counts = dict(ops.LAUNCH_COUNTS)
                T = len(res.round_times)
                replay_ms = (res.round_time * T - res.capture_time) / T * 1e3
                print(f"{where}: wall_s={wall:.3f} capture_s={res.capture_time:.3f} "
                      f"ms/round without capture={replay_ms:.3f} blocked_round="
                      f"{res.blocked_round.tolist()} test_error="
                      f"{[round(e, 2) for e in res.test_error]} launches={counts}")
                grid_gates(where, res, n_min, scenario, err_max, True)
                if engine == "fused_eager":
                    for name, count in counts.items():
                        launches[name] += count
                runs.append({"dataset": dname, "D": D, "scenario": scenario,
                             "route": "afa gram/fused", "engine": engine, "wall_s": wall,
                             "capture_s": res.capture_time, "replay_ms_per_round": replay_ms,
                             "test_error": res.test_error,
                             "blocked_round": res.blocked_round.tolist(), "launches": counts})
            if not same_trajectory(results["fused"], results["fused_eager"]):
                raise AssertionError(f"grid fused [{dname}, {scenario}]: the graph's "
                                     "trajectory differs from the eager body's")
            print(f"grid fused [{dname}, {scenario}]: graph = eager bit for bit")
    wall = time.perf_counter() - t_grid
    print(f"grid: {len(runs)} runs in {wall:.1f} s")
    return runs, noisy, launches, wall


def looped_phase(torch, ops):
    """``LOOPED_SIMS`` on gram/fused with ``engine="looped"`` (one client at
    a time) and ``"batched"``: equal good_mask histories and blocked rounds,
    test error within ``LOOPED_ERR_PP``; ms a round of each.  Returns the
    runs and their launches."""
    import numpy as np

    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig, run
    from repro_torch.kernels.policy import resolve_kernel_plan

    data = make_mnist_like()
    server = ServerConfig(num_clients=MAIN_K, afa_variant="gram",
                          kernel_plan=resolve_kernel_plan(True))
    launches = {name: 0 for name in ops.LAUNCH_COUNTS}
    runs = []
    for label, sim_kw in LOOPED_SIMS.items():
        results = {}
        for engine in ("batched", "looped"):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = results[engine] = run(None, SimConfig(**sim_kw, engine=engine), server,
                                        data=data, device="cuda")
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCH_COUNTS)
            if counts["afa_screen"] != sim_kw["rounds"]:
                raise AssertionError(f"looped [{label}, {engine}]: afa_screen launched "
                                     f"{counts['afa_screen']} times in {sim_kw['rounds']} rounds")
            for name, count in counts.items():
                launches[name] += count
            ms = [t * 1e3 for t in res.round_times]
            print(f"looped [{label}, {engine}]: wall_s={wall:.3f} round_ms="
                  f"{[round(t, 2) for t in ms]} median={sorted(ms)[len(ms) // 2]:.2f} "
                  f"train_ms/round={res.train_time * 1e3:.2f} blocked_round="
                  f"{res.blocked_round.tolist()} test_error="
                  f"{[round(e, 2) for e in res.test_error]}")
            runs.append({"scenario": label, "engine": engine, "wall_s": wall, "round_ms": ms,
                         "train_ms": res.train_time * 1e3, "agg_ms": res.agg_time * 1e3,
                         "test_error": res.test_error,
                         "blocked_round": res.blocked_round.tolist(), "launches": counts})
        a, b = results["looped"], results["batched"]
        gap = float(np.abs(np.asarray(a.test_error) - np.asarray(b.test_error)).max())
        print(f"looped [{label}]: largest test-error gap to batched {gap:.3f} pp; good_mask "
              f"histories equal: {same_trajectory(a, b, error=False)}")
        if not same_trajectory(a, b, error=False):
            raise AssertionError(f"looped [{label}]: good_mask history or blocked rounds "
                                 f"differ from the batched engine's")
        if gap > LOOPED_ERR_PP:
            raise AssertionError(f"looped [{label}]: test error {gap} pp from the batched "
                                 f"engine's > {LOOPED_ERR_PP}")
        runs[-1]["max_err_gap_pp"] = gap
    return runs, launches


def leaf_layout_phase(torch, ops, min_rounds_to_block):
    """``MAIN_SIM`` through ``run`` with ``KernelPlan(mode="cuda",
    layout="leaf")`` on both AFA variants: AFA's tree form blocks every
    byzantine client in round ``min_rounds_to_block()`` and no good one, and
    no AFA kernel is launched.  Then one ``server_step`` on round
    ``LEAF_ROUND``'s recorded proposals (a stacked tree) on the leaf and the
    tree layouts: AFA's equal good_mask and its aggregate within
    ``LEAF_RTOL`` / ``LEAF_ATOL``; fa, mkrum and comed (their kernels on
    the leaf layout's flatten) equal bit for bit.  Returns the runs and the
    steps' launches."""
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig, make_rule_options, run, server_step
    from repro_torch.kernels.policy import KernelPlan
    from repro_torch.utils.trees import tree_leaves

    data = make_mnist_like()
    n_min = min_rounds_to_block()
    plan = KernelPlan(mode="cuda", layout="leaf")
    runs, dump = [], {}
    for variant in ("gram", "iterative"):
        server = ServerConfig(num_clients=MAIN_K, afa_variant=variant, kernel_plan=plan)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with recording_server_step(torch, dump, (LEAF_ROUND,)):
            res = run(None, SimConfig(**MAIN_SIM), server, data=data, device="cuda")
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        print(f"leaf [afa {variant}]: wall_s={wall:.3f} agg_ms/round={res.agg_time * 1e3:.3f} "
              f"blocked_round={res.blocked_round.tolist()} test_error="
              f"{[round(e, 3) for e in res.test_error]} launches={counts}")
        fused_run_gates(f"leaf afa {variant}", "afa", res, n_min)
        if any(counts[name] for name in AFA_KERNELS):
            raise AssertionError(f"leaf [afa {variant}]: AFA kernels launched {counts}")
        runs.append({"route": f"afa {variant}, layout=leaf", "wall_s": wall,
                     "agg_ms": res.agg_time * 1e3, "test_error": res.test_error,
                     "blocked_round": res.blocked_round.tolist(), "launches": counts})
    d = dump[LEAF_ROUND]
    state, tree, n_k, mask0 = d["state"], d["proposals"], d["n_k"], d["mask0"]
    ops.reset_launch_counts()
    for rule in ("afa", *LEAF_EXACT_RULES):
        cfg = ServerConfig(rule=rule, num_clients=MAIN_K, afa_variant="gram", kernel_plan=plan)
        out = {}
        for layout in ("leaf", "tree"):
            before = dict(ops.LAUNCH_COUNTS)
            out[layout] = server_step(state, tree, n_k, mask0, rule=rule,
                                      opts=make_rule_options(cfg, int(mask0.sum())),
                                      layout=layout)[1]
            if layout == "leaf":
                new = {n: c - before[n] for n, c in ops.LAUNCH_COUNTS.items() if c > before[n]}
        torch.cuda.synchronize()
        want = LEAF_EXACT_RULES.get(rule)
        if (want is None and any(n in AFA_KERNELS for n in new)) or (want and want not in new):
            raise AssertionError(f"leaf step [{rule}]: the leaf layout launched {new}, expected "
                                 f"{want or 'no AFA kernel'}")
        if not torch.equal(out["leaf"].good_mask, out["tree"].good_mask):
            raise AssertionError(f"leaf step [{rule}]: good_mask {out['leaf'].good_mask} on "
                                 f"the leaf layout, {out['tree'].good_mask} on the tree one")
        worst = 0.0
        for a, b in zip(tree_leaves(out["leaf"].aggregate), tree_leaves(out["tree"].aggregate)):
            gap = (a - b).abs()
            worst = max(worst, float(gap.max()))
            tol = 0.0 if rule in LEAF_EXACT_RULES else LEAF_ATOL + LEAF_RTOL * b.abs()
            if (gap > tol).any():
                raise AssertionError(f"leaf step [{rule}]: the leaf layout's aggregate is "
                                     f"{float(gap.max())} from the tree layout's")
        print(f"leaf step [{rule}] round {LEAF_ROUND + 1}: good_mask="
              f"{out['leaf'].good_mask.int().tolist()} max |leaf - tree| = {worst:.3e} "
              f"leaf launches={new}")
        runs.append({"step": rule, "round": LEAF_ROUND + 1, "max_abs_gap": worst,
                     "good_mask": out["leaf"].good_mask.tolist()})
    return runs, dict(ops.LAUNCH_COUNTS)


def train_data(torch, cfg):
    """Phase T's batches as the train CLI draws them from seed 0: the eval
    batch, then each round's K clients with the CLI's attack on client 0."""
    import numpy as np

    from repro_torch.data import make_token_stream
    from repro_torch.launch.train import byzantine_batches, make_fed_batches

    r = TRAIN_RUN
    stream = make_token_stream(vocab=cfg.vocab_size, n=50_000)
    rng = np.random.default_rng(0)
    ev = make_fed_batches(cfg, stream, rng, K=1, S=1, b=r["batch"], seq=r["seq"], device="cuda")
    rounds = []
    for rnd in range(r["rounds"]):
        batch = make_fed_batches(cfg, stream, rng, K=r["K"], S=r["local_steps"], b=r["batch"],
                                 seq=r["seq"], device="cuda")
        byzantine_batches(batch, r["byzantine"], rnd, cfg.vocab_size)
        rounds.append(batch)
    return {k: v[0, 0] for k, v in ev.items()}, rounds


def train_mode_run(torch, model, params, data, label):
    """``TRAIN_RUN["rounds"]`` rounds of one of ``TRAIN_MODES`` from
    ``params`` and a fresh reputation: ms a round (host clock to a
    synchronise), the peak of allocated memory over the rounds, the eval
    loss; every round screens out exactly client 0.  Returns the row and each
    round's aggregate (its leaves, on the host)."""
    from repro_torch.core import AFAConfig, init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
    from repro_torch.utils.trees import tree_leaves

    mode, pdt, max_rounds = TRAIN_MODES[label]
    K = TRAIN_RUN["K"]
    fed_round = make_fed_round(model, FedRoundConfig(
        num_clients=K, local_steps=TRAIN_RUN["local_steps"], lr=TRAIN_RUN["lr"],
        afa=AFAConfig(max_rounds=max_rounds), mode=mode, proposal_dtype=pdt))
    rep = init_reputation(K, device="cuda")
    n_k = torch.ones((K,), dtype=torch.float32, device="cuda")
    eval_batch, rounds = data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    p, rows, aggs, peak = params, [], [], 0
    for rnd, batch in enumerate(rounds):
        t0 = time.perf_counter()
        p, rep, m = fed_round(p, rep, n_k, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = max(peak, torch.cuda.max_memory_allocated())
        with torch.no_grad():
            ev = float(model.loss_fn(p, eval_batch)[0])
        row = {"round": rnd, "ms": ms, "good_frac": float(m["good_frac"]),
               "afa_rounds": int(m["afa_rounds"]), "eval_loss": ev,
               "alpha": rep.alpha.tolist(), "beta": rep.beta.tolist(),
               "blocked": rep.blocked.tolist(), "similarities": m["similarities"].tolist()}
        rows.append(row)
        aggs.append([l.cpu() for l in tree_leaves(p)])
        print(f"train [{label}] round {rnd}: {ms:.1f} ms good_frac={row['good_frac']:.2f} "
              f"afa_rounds={row['afa_rounds']} eval_loss={ev:.4f} similarities="
              f"{[round(x, 4) for x in row['similarities']]}")
        n = rnd + 1.0
        if (row["good_frac"] != 0.75 or row["beta"] != [3.0 + n] + [3.0] * (K - 1)
                or row["alpha"] != [3.0] + [3.0 + n] * (K - 1) or any(row["blocked"])):
            raise AssertionError(f"train [{label}] round {rnd}: not exactly client 0 screened "
                                 f"out: {row}")
    del p
    return {"label": label, "mode": mode, "proposal_dtype": pdt, "max_rounds": max_rounds,
            "rounds": rows, "ms_per_round": rows[-1]["ms"], "peak_gb": peak / 1e9,
            "start_gb": start / 1e9}, aggs


def outside(torch, a, b, rtol, atol) -> float:
    """How far the leaves ``a`` lie outside ``rtol``, ``atol`` of ``b``
    (> 0: outside), compared on the card leaf by leaf."""
    worst = float("-inf")
    for x, y in zip(a, b):
        x, y = x.cuda().float(), y.cuda().float()
        worst = max(worst, float(((x - y).abs() - atol - rtol * y.abs()).max()))
    return worst


def rounding_outside(torch, a, b, w) -> float:
    """How far the leaves ``a`` lie outside ``TRAIN_ROUNDING``'s bound of
    ``b`` (a twentieth of b's largest update from the round's start ``w``
    in the leaf, and two bf16 ulps of the value), leaf by leaf (> 0:
    outside)."""
    frac, rtol = TRAIN_ROUNDING
    worst = float("-inf")
    for x, y, z in zip(a, b, w):
        x, y, z = x.cuda().float(), y.cuda().float(), z.cuda().float()
        atol = frac * float((y - z).abs().max())
        worst = max(worst, float(((x - y).abs() - atol - rtol * y.abs()).max()))
    return worst


def train_replay_check(torch, model, params, batch):
    """Trap of ``remat``: a client retrained from the same start gives the
    same bits (every leaf); then, reported, how far each client trained
    alone lies from its row of the K clients trained together."""
    from repro_torch.fed.distributed import _client_train, _clients_train
    from repro_torch.optim import sgd_momentum
    from repro_torch.utils.trees import tree_leaves

    opt = sgd_momentum(TRAIN_RUN["lr"], 0.9)

    def alone(k):
        return tree_leaves(_client_train(model.loss_fn, opt, params,
                                         {n: v[k] for n, v in batch.items()}))

    first, again = alone(1), alone(1)
    bad = [i for i, (x, y) in enumerate(zip(first, again)) if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"train: client 1 retrained gives other bits in {len(bad)} of "
                             f"{len(first)} leaves (first: leaf {bad[0]})")
    together = tree_leaves(_clients_train(model.loss_fn, opt, params, batch))
    rows = []
    for k in range(TRAIN_RUN["K"]):
        solo = first if k == 1 else alone(k)
        differ = sum(int((x != y[k]).sum()) for x, y in zip(solo, together))
        diff = max(float((x.float() - y[k].float()).abs().max()) for x, y in zip(solo, together))
        rows.append({"client": k, "elements_differing": differ, "max_abs_diff": diff})
    print(f"train: client 1 retrained twice: the same bits in all {len(first)} leaves; alone "
          f"vs trained together (vmap): {rows}")
    return rows


def train_cli_run(torch, params, vmap_final):
    """``repro_torch.launch.train.main`` as a user runs it (``TRAIN_CLI``
    with ``--ckpt``): every round prints ``good_frac=0.75``; the checkpoint
    loads back through ``load_pytree`` equal bit for bit to phase T's vmap
    run (the same weights, batches and round) and saves to the same bytes."""
    import io
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.launch import train
    from repro_torch.utils.trees import tree_leaves

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ckpt_000002.msgpack")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(TRAIN_CLI + ["--ckpt", path])
        wall = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"  train CLI: {line}")
        rounds = [line for line in lines if line.startswith("round ")]
        if (rc != 0 or len(rounds) != TRAIN_RUN["rounds"]
                or not all("good_frac=0.75" in line for line in rounds)
                or lines[-1] != f"saved {path}"):
            raise AssertionError(f"train CLI {TRAIN_CLI}: rc {rc}, lines {lines}")
        K = TRAIN_RUN["K"]
        template = {"params": params, "rep": {
            "alpha": torch.zeros(K, device="cuda"), "beta": torch.zeros(K, device="cuda"),
            "blocked": torch.zeros(K, dtype=torch.bool, device="cuda")}}
        restored = load_pytree(path, template)
        got = tree_leaves(restored["params"])
        n_bf16 = sum(l.dtype == torch.bfloat16 for l in got)
        if not all(torch.equal(x.cpu(), y) for x, y in zip(got, vmap_final)):
            raise AssertionError("train CLI: the checkpoint's params differ from phase T's "
                                 "vmap run")
        again = str(Path(tmp) / "again.msgpack")
        save_pytree(again, restored)
        size = Path(path).stat().st_size
        if Path(again).read_bytes() != Path(path).read_bytes():
            raise AssertionError("train CLI: the restored checkpoint saves to other bytes")
    print(f"train CLI: {wall:.1f} s, checkpoint {size / 1e6:.1f} MB ({n_bf16} of {len(got)} "
          f"param leaves bf16) = phase T's vmap run bit for bit, saved again to the same bytes")
    return {"argv": TRAIN_CLI, "wall_s": wall, "lines": lines, "ckpt_mb": size / 1e6,
            "bf16_leaves": n_bf16}


def train_mode_checks(torch, aggs, params, dtype) -> dict:
    """Round 1 of scan and remat against vmap (remat: vmap with one
    screening pass), each within its bound (``TRAIN_BOUNDS``); the max
    |diff| of every round reported.  Raises on a bound missed."""
    from repro_torch.utils.trees import tree_leaves

    start = tree_leaves(params)
    out = {}
    for label, ref in (("scan/float32", "vmap"), ("scan/bfloat16", "vmap"),
                       ("scan/int8", "vmap"), ("remat", "vmap/max_rounds=1")):
        bound = TRAIN_BOUNDS[(dtype, label)]
        a, b = aggs[label][0], aggs[ref][0]
        far = (rounding_outside(torch, a, b, start) if bound == "rounding"
               else outside(torch, a, b, *bound))
        diffs = [max(float((x.float() - y.float()).abs().max()) for x, y in zip(ra, rb))
                 for ra, rb in zip(aggs[label], aggs[ref])]
        out[label] = {"against": ref, "bound": bound, "outside": far, "max_abs_diff": diffs}
    print(f"train [{dtype}]: round 1 of each mode against {{vmap, remat: vmap/max_rounds=1}}, "
          f"how far outside its bound (> 0 fails) and each round's max |diff|: "
          + "; ".join(f"{k} {v['bound']} {v['outside']:.3e} {v['max_abs_diff']}"
                      for k, v in out.items()))
    missed = {k: v["outside"] for k, v in out.items() if v["outside"] > 0}
    if missed:
        raise AssertionError(f"train [{dtype}]: aggregates beyond their bound: {missed}")
    return out


def train_phase(torch):
    """Federated training of whole models (phase T): smollm-135m at full
    width and depth, every ``TRAIN_MODES`` mode on the CLI's batches in
    bf16 (``TRAIN_RUN["rounds"]`` rounds) and on an f32 copy of the weights
    (one round); a client retrained to the same bits; the modes held to one
    another; scan's and remat's peak memory below vmap's; the train CLI.
    Returns the rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_size

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen, "cuda")
    if tree_size(params) != TRAIN_PARAMS:
        raise AssertionError(f"train: {tree_size(params)} parameters, not {TRAIN_PARAMS}")
    cfg32, params32 = as_f32(cfg, params)
    eval_batch, rounds = train_data(torch, cfg)
    rows = {"modes": [], "checks": {}, "replay": {}}
    for dtype, m, p, n in (("bfloat16", model, params, TRAIN_RUN["rounds"]),
                           ("float32", build_model(cfg32), params32, 1)):
        rows["replay"][dtype] = train_replay_check(torch, m, p, rounds[0])
        aggs = {}
        for label in TRAIN_MODES:
            row, aggs[label] = train_mode_run(torch, m, p, (eval_batch, rounds[:n]), label)
            rows["modes"].append(dict(row, dtype=dtype))
        rows["checks"][dtype] = train_mode_checks(torch, aggs, p, dtype)
        by = {r["label"]: r for r in rows["modes"] if r["dtype"] == dtype}
        if [r["alpha"] for r in by["remat"]["rounds"]] != [
                r["alpha"] for r in by["vmap/max_rounds=1"]["rounds"]]:
            raise AssertionError(f"train [{dtype}]: remat's reputation differs from vmap's "
                                 "with one screening pass")
        for label in ("scan/float32", "scan/bfloat16", "scan/int8", "remat"):
            if not by[label]["peak_gb"] < by["vmap"]["peak_gb"]:
                raise AssertionError(f"train [{dtype}]: {label}'s peak {by[label]['peak_gb']:.3f}"
                                     f" GB is not below vmap's {by['vmap']['peak_gb']:.3f} GB")
        if dtype == "bfloat16":
            vmap_final = aggs["vmap"][-1]
        del aggs
    del params32
    rows["cli"] = train_cli_run(torch, params, vmap_final)
    del params, vmap_final
    torch.cuda.empty_cache()
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"train phase: {rows['phase_s']:.1f} s")
    return rows


def prod_model(**over):
    """smollm-135m's published config (with ``over``) built by the port."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    return build_model(get_config(PROD_ARCH).with_(**over))


def median_of(xs):
    return sorted(xs)[len(xs) // 2]


def prod_prefill(torch, ops, smi, launches):
    """``prefill_32k`` on the kernel route (bf16, B = ``PROD_PREFILL_B``):
    a warm-up and ``PROD_TIMED`` timed prefills through ``build_step``, each
    exactly ``num_layers`` ``flash_attn_tc`` launches and nothing else,
    logits finite; ms (median), peak GB, analytic FLOP/s and the model-FLOP
    share.  Returns the row and the bf16 weights."""
    from repro_torch.launch.analytic import analytic_report
    from repro_torch.launch.dryrun import nbytes
    from repro_torch.launch.specs import INPUT_SHAPES, input_specs
    from repro_torch.launch.steps import build_step

    model = prod_model(use_pallas_attention=True)
    cfg = model.config
    torch.cuda.empty_cache()
    bundle = input_specs(model, "prefill_32k", device="cuda", global_batch=PROD_PREFILL_B)
    params, batch = bundle.args
    step = build_step(model, bundle)
    B, L = batch["tokens"].shape
    times, peak, cache_b = [], 0, 0
    with torch.no_grad():
        for i in range(1 + PROD_TIMED):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache = step(params, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = max(peak, torch.cuda.max_memory_allocated())
            counts = {n: c for n, c in ops.LAUNCH_COUNTS.items() if c}
            cache_b = nbytes({k: v for k, v in cache.items() if k != "pos"})
            del cache
            if counts != {"flash_attn_tc": cfg.num_layers}:
                raise AssertionError(f"prod [prefill_32k]: launches {counts}, expected "
                                     f"{cfg.num_layers} flash_attn_tc")
            launches["flash_attn_tc"] += cfg.num_layers
            if logits.shape != (B, cfg.vocab_size) or not torch.isfinite(logits).all():
                raise AssertionError(f"prod [prefill_32k]: logits_last not finite of shape "
                                     f"{(B, cfg.vocab_size)}")
            if i:
                times.append(dt)
    ms = median_of(times) * 1e3
    rep = analytic_report(cfg, "prefill_32k", 1)
    scale = B / INPUT_SHAPES["prefill_32k"]["global_batch"]
    flops, six_nd = rep["analytic_flops"] * scale, rep["model_flops_6nd"] * scale
    row = {"shape": "prefill_32k", "B": B, "L": L, "ms": ms, "ms_all": [t * 1e3 for t in times],
           "peak_gb": peak / 1e9, "cache_gb": cache_b / 1e9, "analytic_flops": flops,
           "model_flops_6nd": six_nd, "analytic_tflops_per_s": flops / (ms / 1e3) / 1e12,
           "model_flop_share": six_nd / (ms / 1e3) / BF16_DENSE_PEAK,
           "flash_attn_tc_per_prefill": cfg.num_layers,
           "cut": None if B == 32 else f"B 32 -> {B}"}
    print(f"prod [prefill_32k, kernel route, bf16] ({smi}): B={B} L={L} ms={ms:.1f} (each "
          f"{[round(t * 1e3, 1) for t in times]}) peak_GB={row['peak_gb']:.2f} cache_GB="
          f"{row['cache_gb']:.2f} analytic_TFLOP/s={row['analytic_tflops_per_s']:.1f} "
          f"model_flop_share={row['model_flop_share']:.4f} flash_attn_tc/prefill="
          f"{cfg.num_layers}")
    del bundle, batch, step
    torch.cuda.empty_cache()
    return row, params


def prod_long_context(torch, ops, smi, params16, launches):
    """f32, B = 1, on the f32 kernel: the kernel-route forward against the
    plain route at ``PROD_LONG_L`` tokens (within ``FWD_TOL``), and the
    kernel-route prefill's ``logits_last`` at 32,768 against the
    kernel-route forward's last position (within ``FWD_TOL``); each
    kernel-route call exactly ``num_layers`` ``flash_attn`` launches, the
    plain route none."""
    from repro_torch.launch.specs import INPUT_SHAPES
    from repro_torch.models import build_model

    cfg32, p32 = as_f32(prod_model().config, params16)
    kern = build_model(cfg32.with_(use_pallas_attention=True))
    plain = build_model(cfg32)
    seq = INPUT_SHAPES["prefill_32k"]["seq"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    tokens = torch.randint(0, cfg32.vocab_size, (1, seq), generator=gen, device="cuda")
    n = cfg32.num_layers

    def run(label, fn, want):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: c for k, c in ops.LAUNCH_COUNTS.items() if c}
        if counts != want:
            raise AssertionError(f"prod [long context] {label}: launches {counts}, expected "
                                 f"{want}")
        launches["flash_attn"] += want.get("flash_attn", 0)
        return out, ms

    row = {"L_compared": PROD_LONG_L, "L_prefill": seq}
    with torch.no_grad():
        short = {"tokens": tokens[:, :PROD_LONG_L]}
        a, row["kernel_forward_ms"] = run("kernel forward",
                                          lambda: kern.forward(p32, short), {"flash_attn": n})
        b, row["plain_forward_ms"] = run("plain forward", lambda: plain.forward(p32, short), {})
        diff = float((a - b).abs().max())
        excess = float(((a - b).abs() - FWD_TOL * b.abs()).max())
        finite = bool(torch.isfinite(a).all())
        del a, b
        if excess > FWD_TOL or not finite:
            raise AssertionError(f"prod [long context]: f32 kernel-route logits at "
                                 f"{PROD_LONG_L} beyond atol = rtol = {FWD_TOL} of the plain "
                                 f"route's (max diff {diff})")
        row["max_abs_diff_kernel_vs_plain"] = diff
        (last, cache), row["kernel_prefill_ms"] = run(
            "kernel prefill", lambda: kern.prefill(p32, {"tokens": tokens}, cache_size=seq),
            {"flash_attn": n})
        del cache
        full, row["kernel_forward_32k_ms"] = run(
            "kernel forward 32k", lambda: kern.forward(p32, {"tokens": tokens}),
            {"flash_attn": n})
        at_end = full[:, -1].clone()
        del full
    diff_last = float((last - at_end).abs().max())
    if beyond(torch, last, at_end, FWD_TOL) > 0 or not torch.isfinite(last).all():
        raise AssertionError(f"prod [long context]: prefill logits_last at {seq} beyond "
                             f"{FWD_TOL} of the forward's last position (max diff {diff_last})")
    row["max_abs_diff_prefill_last_vs_forward"] = diff_last
    print(f"prod [long context, f32, B=1] ({smi}): kernel forward vs plain at {PROD_LONG_L}: "
          f"max |logit diff|={diff:.3e} (atol = rtol = {FWD_TOL}); kernel "
          f"{row['kernel_forward_ms']:.1f} ms, plain {row['plain_forward_ms']:.1f} ms; at {seq}: "
          f"prefill logits_last vs the "
          f"forward's last position max |diff|={diff_last:.3e}, prefill "
          f"{row['kernel_prefill_ms']:.1f} ms, forward {row['kernel_forward_32k_ms']:.1f} ms; "
          f"{n} flash_attn launches each")
    del p32, kern, plain
    torch.cuda.empty_cache()
    return row


def prod_sdpa_ms(torch, q, k, v, flush):
    """The library call's time on the flash kernels' (B, L, H, D) inputs:
    ``F.scaled_dot_product_attention`` on (B, H, L, D) copies, causal, GQA
    (``enable_gqa``), by ``time_ms``.  Where the backend SDPA picks cannot
    hold its work in the card's memory, ``(None, "does not fit: <the
    allocator's message>")``, the bytes it asked for in the message."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        ms = time_ms(torch, {"library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}, flush)["library_ms"]
    except torch.OutOfMemoryError as e:  # the measurement's answer, not a failure
        first = str(e).splitlines()[0]
        del qt, kt, vt
        torch.cuda.empty_cache()
        return None, f"does not fit: {first}"
    del qt, kt, vt
    return ms, f"{ms:.3f} ms"


def prod_twins(torch, ops, ref, smi):
    """Both flash kernels against the twins of their arithmetic at smollm's
    heads (9/3, D = 64, causal), each at the batch the main path gives it:
    the f32 kernel at B = 1 (the long-context check's), the bf16 kernel at
    B = ``PROD_PREFILL_B`` (``prefill_32k``'s grid), one launch over the
    whole batch with its first and last rows each held to the twin run on
    that row alone (f32: ``TF32_ATTN_RTOL``, bf16: one output ulp, each at
    that row's v scale); at the longest ``PROD_TWIN_LS`` length whose twin
    and tensors fit the free memory; a bit-identical rerun; the kernel's ms
    (``time_ms``).  Comparison launches: the counts are reset after."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    rows = []
    for dt, B in ((torch.float32, 1), (torch.bfloat16, PROD_PREFILL_B)):
        dname = str(dt).split(".")[-1]
        esize = torch.finfo(dt).bits // 8
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        # the twins' largest transients: float64 (L, Hq, 64) slices, ~16
        # alive; the kernel's q, k, v, out and rerun: 9 + 3 + 3 + 9 + 9 heads
        L = next(l for l in PROD_TWIN_LS
                 if 16 * l * 9 * 64 * 8 + B * l * 33 * 64 * esize < free / 2)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(17)
        q, k, v = (torch.randn((B, L, h, 64), generator=gen, device="cuda").to(dt)
                   for h in (9, 3, 3))
        out = ops.flash_attention(q, k, v, causal=True)
        errs, tols = [], []
        for b in sorted({0, B - 1}):
            one = slice(b, b + 1)
            if dt == torch.float32:
                twin = ref.flash_attention_3xtf32_ref(q[one], k[one], v[one], causal=True,
                                                      block_k=ops.ATTN_TC_BLOCK_K)
                tol, what = TF32_ATTN_RTOL * float(v[one].abs().max()), "TF32_ATTN_RTOL"
            else:
                twin = ref.flash_attention_tc_ref(q[one], k[one], v[one], causal=True,
                                                  block_k=ops.ATTN_TC_BLOCK_K)
                tol = ATTN_TC_ULP[dname] * float(v[one].float().abs().max())
                what = "one output ulp"
            errs.append(float((out[one].float() - twin.float()).abs().max()))
            tols.append(tol)
            del twin
        again = ops.flash_attention(q, k, v, causal=True)
        name = "flash_attn" if dt == torch.float32 else "flash_attn_tc"
        ms = time_ms(torch, {name: lambda: ops.flash_attention(q, k, v, causal=True)},
                     flush)[name]
        library_ms, library = prod_sdpa_ms(torch, q, k, v, flush)
        if (any(e > t for e, t in zip(errs, tols)) or not torch.isfinite(out).all()
                or not torch.equal(out, again)):
            raise AssertionError(f"prod [twins] {name} {dname} at B={B} L={L}: max |kernel - "
                                 f"twin| of rows 0 and {B - 1} {errs} > {what} {tols}, or not "
                                 f"finite, or reruns differ")
        rows.append({"name": name, "dtype": dname, "B": B, "L": L, "rows_compared":
                     sorted({0, B - 1}), "max_abs_err_arith_twin": max(errs),
                     "max_abs_err_rows": errs, "tol": min(tols), "ms": ms,
                     "library_ms": library_ms, "library": library})
        print(f"prod [twins] {name} {dname} ({B}, {L}, {L}, 9, 3, 64) causal ({smi}): rows "
              f"{rows[-1]['rows_compared']} each against the twin on that row: max |kernel - "
              f"arithmetic twin|={[f'{e:.3e}' for e in errs]} (tol "
              f"{[f'{t:.3e}' for t in tols]}, {what}) bit-identical, kernel_ms={ms:.3f} "
              f"(median of {N_TIMED}, L2 flushed); the longest of {PROD_TWIN_LS} that fits; "
              f"library (SDPA, GQA, causal): {library}")
        del q, k, v, out, again
    del flush
    ops.reset_launch_counts()
    return rows


def prod_decode(torch, ops, smi, shape, global_batch=None):
    """``decode_32k`` or ``long_500k`` (bf16): the spec's cache filled from
    the seed and used in place as a ``DecodeProgram``'s buffer; the eager serve step
    (``build_step``) and one graph replay from the same state equal bit for
    bit (logits, the written cache slot of every layer, the next position);
    ms a step replayed (median of ``PROD_REPLAYS``, the state restored
    before each) and eager, the step's transient memory, its share of the
    card's bytes rate, the time the step's per-layer f32 widening of the
    cache takes, and for ``decode_32k`` a traced replay (state restored
    first)."""
    from repro_torch.launch.analytic import analytic_report
    from repro_torch.launch.dryrun import nbytes
    from repro_torch.launch.serve import DecodeProgram
    from repro_torch.launch.specs import INPUT_SHAPES, input_specs
    from repro_torch.launch.steps import build_step

    model = prod_model()
    torch.cuda.empty_cache()
    bundle = input_specs(model, shape, device="cuda", global_batch=global_batch)
    params, cache, tokens, pos = bundle.args
    B, S, ring = tokens.shape[0], bundle.meta["cache_size"], bundle.meta["ring"]
    p = INPUT_SHAPES[shape]["seq"] - 1
    slot = p % S if ring else p
    step = build_step(model, bundle)
    prog = DecodeProgram(model, params, cache, ring=ring, greedy=True)
    kv = cache["layers"]
    snap = [t[:, :, slot].clone() for t in kv]

    def restore():
        for t, s in zip(kv, snap):
            t[:, :, slot].copy_(s)
        cache["pos"].copy_(pos)
        prog.tok.copy_(tokens)

    def state(logits):
        return [logits.clone(), *(t[:, :, slot].clone() for t in kv), cache["pos"].clone()]

    def widen(kv):
        """The step's f32 copies of the bf16 cache, one layer's k or v at a
        time, each dropped at once."""
        for i in range(kv[0].shape[0]):
            for t in kv:
                t[i].float()

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    ops.reset_launch_counts()
    restore()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _, (logits, _) = timed(lambda: step(params, cache, tokens, pos))
        transient = torch.cuda.max_memory_allocated() - base
        eager = state(logits)
        eager_ms = []
        for _ in range(3):
            restore()
            eager_ms.append(timed(lambda: step(params, cache, tokens, pos))[0])
        restore()
        prog.capture()
        restore()
        prog.run()
        graph = state(prog.logits)
        replay_ms = []
        for _ in range(PROD_REPLAYS):
            restore()
            replay_ms.append(timed(prog.run)[0])
        widen_ms = median_of([timed(lambda: widen(kv))[0] for _ in range(3)])
        traced = None
        if shape == "decode_32k":  # where a replayed step's time goes
            traced = trace(torch, f"{shape} B={B} step, graph-replayed",
                           lambda: (restore(), prog.run(), {})[-1], 1)
    if any(ops.LAUNCH_COUNTS.values()):
        raise AssertionError(f"prod [{shape}]: the decode step launched {ops.LAUNCH_COUNTS}")
    same = all(torch.equal(a, b) for a, b in zip(eager, graph))
    if (not same or eager[-1].tolist() != [p + 1] * B
            or not torch.isfinite(eager[0]).all()):
        raise AssertionError(f"prod [{shape}]: the graph-replayed step differs from the eager "
                             f"step (bit for bit {same}) or pos {eager[-1].tolist()[:4]} != "
                             f"{p + 1}, or logits not finite")
    ms, e_ms = median_of(replay_ms), median_of(eager_ms)
    cache_b = nbytes(kv)
    param_b = nbytes(params)
    rep = analytic_report(model.config, shape, 1)
    scale = B / INPUT_SHAPES[shape]["global_batch"]
    row = {"shape": shape, "B": B, "cache_slots": S, "ring": ring, "pos": p,
           "graph_ms_per_step": ms, "eager_ms_per_step": e_ms, "tokens_per_s": B / (ms / 1e3),
           "cache_gb": cache_b / 1e9, "param_gb": param_b / 1e9,
           "byte_share": (cache_b + param_b) / (ms / 1e3) / HBM_BYTES_PER_S,
           "transient_gb": transient / 1e9, "widen_ms": widen_ms,
           "widen_share": widen_ms / ms, "capture_s": prog.capture_s,
           "analytic_flops": rep["analytic_flops"] * scale, "trace": traced,
           "cut": None if scale == 1 else f"B {INPUT_SHAPES[shape]['global_batch']} -> {B}"}
    print(f"prod [{shape}, bf16, {'ring' if ring else 'linear'} cache of {S} slots, pos={p}] "
          f"({smi}): B={B} graph = eager bit for bit; ms/step replayed={ms:.3f} eager={e_ms:.3f}"
          f" tokens/s={row['tokens_per_s']:.0f} cache_GB={row['cache_gb']:.2f} byte_share="
          f"{row['byte_share']:.4f} transient_GB={row['transient_gb']:.2f} f32 widening of the "
          f"cache {widen_ms:.3f} ms ({row['widen_share']:.3f} of a replayed step) capture_s="
          f"{prog.capture_s:.3f}")
    del prog, step, bundle, cache, kv, snap, params, eager, graph
    torch.cuda.empty_cache()
    return row


def prod_ring_window(torch, smi, params16):
    """``long_500k`` in f32: the ring step over its ``sliding_window``
    slots (seeded) at position 524,287 against the window decode of a
    linear cache of 524,288 slots holding the same 8,192 entries, logits
    within ``SERVE_TF_TOL[1]``, the greedy token equal, the first layer's
    written key and value equal bit for bit (the later layers' inputs
    carry the attention's rounding)."""
    from repro_torch.launch.dryrun import nbytes
    from repro_torch.launch.specs import INPUT_SHAPES
    from repro_torch.models import build_model

    cfg32, p32 = as_f32(prod_model().config, params16)
    model = build_model(cfg32)
    w, seq = cfg32.sliding_window, INPUT_SHAPES["long_500k"]["seq"]
    pos = seq - 1
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    ring = model.init_cache(1, w, torch.float32, device="cuda")
    for t in ring["layers"]:
        t.normal_(generator=gen)
    lin = model.init_cache(1, seq, torch.float32, device="cuda")
    for r, l in zip(ring["layers"], lin["layers"]):
        l[:, :, seq - w:].copy_(r)   # slot pos % w of the ring = position seq - w + slot
    ring["pos"].fill_(pos)
    lin["pos"].fill_(pos)
    tok = torch.randint(0, cfg32.vocab_size, (1,), generator=gen, device="cuda")
    with torch.no_grad():
        lr, _ = model.decode_step(p32, ring, tok, ring=True)
        lw, _ = model.decode_step(p32, lin, tok, ring=False)
    diff = float((lr - lw).abs().max())
    kv_same = all(torch.equal(r[0, :, pos % w], l[0, :, pos])
                  for r, l in zip(ring["layers"], lin["layers"]))
    kv_diff = max(float((r[:, :, pos % w] - l[:, :, pos]).abs().max())
                  for r, l in zip(ring["layers"], lin["layers"]))
    if (beyond(torch, lr, lw, SERVE_TF_TOL[1]) > 0 or not kv_same
            or not torch.equal(lr.argmax(-1), lw.argmax(-1))):
        raise AssertionError(f"prod [long_500k f32]: ring step != window decode over the same "
                             f"{w} entries (max |logit diff| {diff}, layer 0's written k/v equal "
                             f"{kv_same})")
    row = {"window": w, "pos": pos, "max_abs_diff": diff, "written_kv_max_abs_diff": kv_diff,
           "linear_cache_gb": nbytes(lin["layers"]) / 1e9}
    print(f"prod [long_500k ring = window, f32, B=1, pos={pos}] ({smi}): max |logit diff|="
          f"{diff:.3e} (atol = rtol = {SERVE_TF_TOL[1]}), greedy token equal, layer 0's written "
          f"k/v equal, every layer's within {kv_diff:.3e}; the window's linear cache "
          f"{row['linear_cache_gb']:.2f} GB")
    del ring, lin, p32, model
    torch.cuda.empty_cache()
    return row


def prod_train(torch, smi):
    """``train_4k`` (``PROD_TRAIN``): one round of K = 4 clients, client 0
    byzantine, through ``input_specs(..., device="cuda")`` and
    ``build_step``; exactly client 0 screened out; ms a round, peak GB, the
    model-FLOP share of the round."""
    from repro_torch.launch.analytic import analytic_report, n_matmul_active
    from repro_torch.launch.specs import INPUT_SHAPES, LOCAL_STEPS, input_specs
    from repro_torch.launch.steps import build_step
    from repro_torch.launch.train import byzantine_batches

    r = PROD_TRAIN
    model = prod_model(fed_mode="scan", fed_clients=4)
    cfg = model.config
    torch.cuda.empty_cache()
    bundle = input_specs(model, "train_4k", r["client_rows"], device="cuda",
                         global_batch=r["per_client_batch"], local_steps=r["local_steps"])
    params, rep, n_k, batch = bundle.args
    K, S, b, L = batch["tokens"].shape
    byzantine_batches(batch, 1, 0, cfg.vocab_size)
    step = build_step(model, bundle, lr=r["lr"], local_steps=S, microbatch=b,
                      proposal_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agg, rep2, m = step(params, rep, n_k, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    got = {"good_frac": float(m["good_frac"]), "alpha": rep2.alpha.tolist(),
           "beta": rep2.beta.tolist(), "blocked": rep2.blocked.tolist()}
    if got != {"good_frac": 0.75, "alpha": [3.0] + [4.0] * (K - 1),
               "beta": [4.0] + [3.0] * (K - 1), "blocked": [False] * K}:
        raise AssertionError(f"prod [train_4k]: not exactly client 0 screened out: {got}")
    tokens = K * S * b * L
    six_nd = 6.0 * n_matmul_active(cfg) * tokens
    full = analytic_report(cfg, "train_4k", r["client_rows"])
    scale = (b / INPUT_SHAPES["train_4k"]["global_batch"]) * (S / LOCAL_STEPS)
    row = {"shape": "train_4k", "mode": cfg.fed_mode, "K": K, "per_client_batch": b,
           "local_steps": S, "seq": L, "microbatch": b, "tokens": tokens, "ms": ms,
           "peak_gb": peak / 1e9, "model_flops_6nd": six_nd,
           "model_flop_share": six_nd / (ms / 1e3) / BF16_DENSE_PEAK,
           "analytic_flops": full["analytic_flops"] * scale, "afa_rounds": int(m["afa_rounds"]),
           "similarities": m["similarities"].tolist(), **got,
           "cut": f"vmap -> scan, b 64 -> {b}, local steps {LOCAL_STEPS} -> {S}"}
    print(f"prod [train_4k, {cfg.fed_mode}, K={K} b={b} S={S} L={L}, bf16] ({smi}): exactly "
          f"client 0 screened out (alpha {got['alpha']}, beta {got['beta']}); ms/round={ms:.1f}"
          f" peak_GB={row['peak_gb']:.2f} tokens={tokens} model_flop_share="
          f"{row['model_flop_share']:.4f} afa_rounds={row['afa_rounds']}")
    del bundle, params, batch, step, agg
    torch.cuda.empty_cache()
    return row


@functools.lru_cache(maxsize=1)
def mnist_like(n_train: int):
    """``make_mnist_like(n_train=n_train)`` (seed 0), made once for the
    phases that share it (the C.8 share run and phase H, 200,000 samples)."""
    from repro_torch.data import make_mnist_like

    return make_mnist_like(n_train=n_train)


def shard_server():
    from repro_torch.fed import ServerConfig
    from repro_torch.kernels.policy import resolve_kernel_plan

    return ServerConfig(num_clients=SHARD_K, afa_variant="iterative",
                        kernel_plan=resolve_kernel_plan(True))


def shard_afa_alone(torch, mesh, ops):
    """The sharded ``afa_aggregate`` on this rank's rows of the seeded
    ``screening_inputs`` (200, D_PAPER) matrix, against the unsharded call
    on the whole matrix (on rank 0), in both loop forms; then the sharded
    call's median ms over ``SHARD_TIMED`` calls (host clock around each
    call, synchronized), and one call traced on rank 0: the device time of
    the two kernels and of everything else, and the host time inside the
    mesh's all-reduces (which waits for the device work before it: gloo
    copies through the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import AFAConfig, afa_aggregate
    from repro_torch.launch.mesh import ALL_REDUCE_RANGE

    _, _, Us, pn, mask0 = screening_inputs(torch, SHARD_AFA_K, D_PAPER, 7)
    ones = torch.ones_like(pn)
    rows = SHARD_AFA_K // mesh.num_shards
    blk = mesh.row_block(rows)
    local = (Us[blk].contiguous(), pn[blk], ones[blk], mask0[blk])
    sharded = AFAConfig(variant="iterative", use_kernels="cuda", client_mesh=mesh)
    out = {"checks": []}
    for unroll in (False, True):
        got = afa_aggregate(*local, sharded, unroll=unroll)
        good = mesh.gather_rows(got.good_mask.to(torch.uint8), SHARD_AFA_K).bool()
        if mesh.rank == 0:
            want = afa_aggregate(Us, pn, ones, mask0, AFAConfig(variant="iterative",
                                                                use_kernels="cuda"),
                                 unroll=unroll)
            scale = float(want.aggregate.abs().max())
            err = float((got.aggregate - want.aggregate).abs().max())
            check = {"unroll": unroll, "rounds": int(got.rounds),
                     "rounds_unsharded": int(want.rounds),
                     "good_mask_equal": bool(torch.equal(good, want.good_mask)),
                     "kept": int(good.sum()), "max_abs_err": err, "scale": scale}
            out["checks"].append(check)
            if not check["good_mask_equal"] or check["rounds"] != check["rounds_unsharded"]:
                raise AssertionError(f"sharded afa_aggregate (unroll={unroll}): {check}")
            if err > SHARD_AGG_RTOL * scale:
                raise AssertionError(f"sharded afa_aggregate (unroll={unroll}): aggregate off "
                                     f"by {err} > {SHARD_AGG_RTOL} * {scale}")

    def call():
        r = afa_aggregate(*local, sharded)
        torch.cuda.synchronize()
        return r

    call()
    times = []
    for _ in range(SHARD_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = sorted(times)[len(times) // 2]
    out["ms_all"] = times
    calls = mesh.all_reduces
    if mesh.rank == 0:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            wall = (time.perf_counter() - t0) * 1e3
        spans = device_spans(torch, prof)
        ours = {n: (sum(e - b for b, e, k in spans if f"{n}_kernel" in k),
                    sum(1 for _, _, k in spans if f"{n}_kernel" in k)) for n in SHARD_CALLS}
        reduce_us = [e.time_range.end - e.time_range.start for e in prof.events()
                     if e.name == ALL_REDUCE_RANGE and e.device_type == DeviceType.CPU]
        out["trace"] = {
            "wall_ms": wall, "device_busy_ms": busy_us(spans) / 1e3,
            "kernels": {n: {"ms": t / 1e3, "count": c} for n, (t, c) in ours.items()},
            "other_device_ms": (busy_us(spans) - sum(t for t, _ in ours.values())) / 1e3,
            "all_reduce_host_ms": sum(reduce_us) / 1e3, "all_reduces": len(reduce_us)}
    else:
        call()
    out["all_reduces_a_call"] = mesh.all_reduces - calls
    return out


def shard_worker(data, server, traced_run: bool):
    """One rank of phase H (run on every rank of the caller's group): the
    all-reduce of each dtype the mesh carries on this backend; then
    ``SHARD_SIM`` through ``repro_torch.fed.api.run`` with the wrapper
    counts set to 0 just before and summed over the ranks just after; with
    ``traced_run``, the same run again, traced on rank 0, its
    ``weighted_sum`` / ``cosine_sim`` kernels counted in the trace against
    rank 0's wrapper counts; and the sharded aggregate alone.  The rows a
    shard of each layout the segmented run takes are recorded (around
    ``fed.simulator._compact_inputs``).  Returns rank 0's numbers."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.fed.simulator as simulator
    from repro_torch.fed import SimConfig, run
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_client_mesh

    t_worker = time.perf_counter()
    S = dist.get_world_size()
    mesh = make_client_mesh(S, "cuda")
    layouts, compact = [], simulator._compact_inputs

    def recording(setup, kept, rows):
        layouts.append(int(rows))
        return compact(setup, kept, rows)

    simulator._compact_inputs = recording
    dtypes = {}
    for name in SHARD_DTYPES:
        t = mesh.psum(torch.ones((3,), dtype=getattr(torch, name), device=mesh.device))
        dtypes[name] = t.tolist()
    sim = SimConfig(**SHARD_SIM, client_shards=S)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(None, sim, server, data=data, device="cuda")
    wall = time.perf_counter() - t0
    simulator._compact_inputs = compact
    mine = torch.tensor([[ops.LAUNCH_COUNTS[n] for n in SHARD_CALLS]], dtype=torch.float64,
                        device=mesh.device)
    by_rank = [dict(zip(SHARD_CALLS, map(int, r))) for r in mesh.gather_rows(mine, S).tolist()]
    out = {"ranks": S, "backend": mesh.backend, "dtypes": dtypes, "result": res,
           "wall_s": wall, "rows_a_shard": layouts, "launches_by_rank": by_rank,
           "launches": {n: sum(r[n] for r in by_rank) for n in SHARD_CALLS}}
    if traced_run:
        ops.reset_launch_counts()
        if mesh.rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(None, sim, server, data=data, device="cuda")
                torch.cuda.synchronize()
            seen = our_kernels(device_spans(torch, prof))
            out["traced"] = {n: seen.get(f"{n}_kernel", 0) for n in SHARD_CALLS}
            out["traced_wrapper_counts"] = {n: ops.LAUNCH_COUNTS[n] for n in SHARD_CALLS}
        else:
            run(None, sim, server, data=data, device="cuda")
        out["afa_alone"] = shard_afa_alone(torch, mesh, ops)
    out["worker_s"] = time.perf_counter() - t_worker
    return out


def shard_phase(torch, ops, smi, min_rounds_to_block):
    """Phase H: the client-sharded fused engine (``SimConfig.client_shards``).
    ``SHARD_SIM`` unsharded (``engine="fused"``, the round graph replayed),
    then through one NCCL rank (``launch.shards.run_sharded``): equal bit for
    bit; then on ``SHARD_S`` gloo ranks sharing the card
    (``launch.shards.spawn`` of ``shard_worker``), held to the unsharded run
    by ``shard_ranks``, and the sharded aggregate alone against the
    unsharded call.  With two cards or more, the same on one NCCL rank a
    card.  Returns the phase's numbers and the launches of the sharded
    runs' wrappers, summed over the ranks."""
    from repro_torch.fed import SimConfig, run
    from repro_torch.launch.shards import run_sharded, spawn

    t_phase = time.perf_counter()
    data = mnist_like(SHARD_N_TRAIN)
    server = shard_server()
    n_min = min_rounds_to_block()
    t0 = time.perf_counter()
    ref = run(None, SimConfig(**SHARD_SIM), server, data=data, device="cuda")
    ref_wall = time.perf_counter() - t0
    T = SHARD_SIM["rounds"]
    row = {"config": {k: v for k, v in SHARD_SIM.items() if k != "hidden"},
           "unsharded": {"wall_s": ref_wall, "capture_s": ref.capture_time,
                         "ms_per_round_without_capture":
                             (ref.round_time * T - ref.capture_time) / T * 1e3,
                         "test_error": ref.test_error,
                         "blocked_round": ref.blocked_round.tolist()}}
    print(f"shards [unsharded, {SHARD_K} clients]: wall_s={ref_wall:.2f} capture_s="
          f"{ref.capture_time:.2f} blocked={int((ref.blocked_round > 0).sum())} in rounds "
          f"{sorted(set(ref.blocked_round.tolist()))} test_error="
          f"{[round(e, 3) for e in ref.test_error]}")

    t0 = time.perf_counter()
    one = run_sharded(None, SimConfig(**SHARD_SIM, client_shards=1), server, data=data,
                      device="cuda")
    row["nccl_one_rank"] = {"wall_s": time.perf_counter() - t0,
                            "bit_for_bit": same_trajectory(one, ref)}
    print(f"shards [1 NCCL rank]: run_sharded = the unsharded run bit for bit: "
          f"{row['nccl_one_rank']['bit_for_bit']} (wall_s={row['nccl_one_rank']['wall_s']:.2f})")
    if not row["nccl_one_rank"]["bit_for_bit"]:
        raise AssertionError("shards: one NCCL rank differs from the unsharded run")

    t0 = time.perf_counter()
    four = spawn(shard_worker, SHARD_S, backend="gloo", device="cuda:0",
                 args=(data, server, True))
    row["gloo"] = shard_ranks(f"{SHARD_S} gloo ranks on cuda:0", four,
                              time.perf_counter() - t0, ref, n_min)
    cards = torch.cuda.device_count()
    if cards >= 2 and SHARD_K % cards == 0:
        t0 = time.perf_counter()
        many = spawn(shard_worker, cards, backend="nccl", device="cuda", args=(data, server, True))
        row["nccl"] = shard_ranks(f"{cards} NCCL ranks, one a card", many,
                                  time.perf_counter() - t0, ref, n_min)
    else:
        row["nccl"] = f"did not run: {cards} card(s)"
        print(f"shards [NCCL, one rank a card]: did not run ({cards} card on this machine)")
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"shards: phase {row['phase_s']:.1f} s ({smi})")
    launches = dict(four["launches"])
    if isinstance(row["nccl"], dict):
        for n, c in row["nccl"]["launches"].items():
            launches[n] += c
    return row, launches


def shard_ranks(label, out, spawn_wall, ref, n_min):
    """The gates and numbers of one sharded run of ``shard_worker`` (``out``,
    rank 0's) against the unsharded run ``ref``: every round's good_mask and
    the blocked rounds equal, test error within ``SHARD_ERR_TOL``, the
    byzantine clients blocked in round ``n_min`` and no good one, the
    segments on ``K / S`` rows a shard and then on the live clients'
    smaller power-of-two bucket, every rank's wrapper counts the same (one
    to AFA's ``max_rounds`` screening passes a round, a ``weighted_sum``
    and a ``cosine_sim`` each, and one final ``weighted_sum``), rank 0's
    trace the same; ms a round by segment, the sharded aggregate alone."""
    import numpy as np

    from repro_torch.core import AFAConfig
    from repro_torch.data import pow2_bucket

    res, S, T = out["result"], out["ranks"], SHARD_SIM["rounds"]
    max_passes = AFAConfig().max_rounds
    err = float(np.max(np.abs(np.asarray(res.test_error) - np.asarray(ref.test_error))))
    bad = set(ref.bad_clients.tolist())
    blocked = {k for k in range(SHARD_K) if res.blocked_round[k] > 0}
    seg_ms = [float(np.mean(res.round_times[i:i + SHARD_SIM["segment_rounds"]])) * 1e3
              for i in range(0, T, SHARD_SIM["segment_rounds"])]
    row = {"ranks": S, "backend": out["backend"], "spawn_wall_s": spawn_wall,
           "worker_s": out["worker_s"], "run_wall_s": out["wall_s"],
           "ms_per_round_by_segment": seg_ms, "rows_a_shard": out["rows_a_shard"],
           "dtypes": out["dtypes"],
           "good_mask_equal": bool(np.array_equal(np.stack(res.good_mask_history),
                                                  np.stack(ref.good_mask_history))),
           "blocked_round_equal": bool(np.array_equal(res.blocked_round, ref.blocked_round)),
           "max_test_error_diff": err, "test_error": res.test_error,
           "launches": out["launches"], "launches_by_rank": out["launches_by_rank"],
           "traced_rank0": out["traced"], "traced_wrapper_counts": out["traced_wrapper_counts"],
           "afa_alone": out["afa_alone"]}
    print(f"shards [{label}]: spawn wall_s={spawn_wall:.2f} (rank 0's worker "
          f"{out['worker_s']:.2f}), run wall_s={out['wall_s']:.2f}, ms/round by segment "
          f"{[round(m, 3) for m in seg_ms]}, rows a shard {out['rows_a_shard']}; good_mask equal {row['good_mask_equal']}, blocked "
          f"rounds equal {row['blocked_round_equal']}, max |test error diff| {err:.3g} pp; "
          f"launches {out['launches']} (by rank {out['launches_by_rank']}, traced on rank 0 "
          f"{out['traced']}); all-reduce dtypes {out['dtypes']}")
    a = out["afa_alone"]
    t = a["trace"]
    print(f"shards [afa_aggregate alone, ({SHARD_AFA_K}, {D_PAPER}) over {label}]: "
          f"{a['checks']}; "
          f"ms median={a['ms']:.3f} "
          f"({a['all_reduces_a_call']} all-reduces a call); traced "
          f"call wall_ms={t['wall_ms']:.3f}: kernels "
          + ", ".join(f"{n} {v['ms']:.3f} ms x{v['count']}" for n, v in t["kernels"].items())
          + f", other device {t['other_device_ms']:.3f} ms, host in {t['all_reduces']} "
          f"all-reduces {t['all_reduce_host_ms']:.3f} ms")
    if not (row["good_mask_equal"] and row["blocked_round_equal"]):
        raise AssertionError(f"shards [{label}]: differs from the unsharded run: {row}")
    if err > SHARD_ERR_TOL:
        raise AssertionError(f"shards [{label}]: test error off by {err} pp > {SHARD_ERR_TOL}")
    if blocked != bad or set(res.blocked_round[sorted(bad)].tolist()) != {n_min}:
        raise AssertionError(f"shards [{label}]: blocked {sorted(blocked)} in rounds "
                             f"{res.blocked_round.tolist()}, expected the {len(bad)} byzantine "
                             f"clients in round {n_min}")
    rows = SHARD_K // S
    live_rows = pow2_bucket(-(-(SHARD_K - len(bad)) // S), rows)
    if live_rows >= rows or out["rows_a_shard"] != [rows, live_rows]:
        raise AssertionError(f"shards [{label}]: rows a shard {out['rows_a_shard']}, expected "
                             f"{rows} and then {live_rows} once the byzantine are blocked")
    rank0 = out["launches_by_rank"][0]
    passes = rank0["cosine_sim"]
    if (any(r != rank0 for r in out["launches_by_rank"]) or rank0["weighted_sum"] != passes + T
            or not T <= passes <= max_passes * T):
        raise AssertionError(f"shards [{label}]: wrapper counts by rank "
                             f"{out['launches_by_rank']}, expected the same on every rank, "
                             f"{T} to {max_passes * T} passes and one more weighted_sum "
                             "a round")
    if out["traced"] != out["traced_wrapper_counts"] or out["traced"] != rank0:
        raise AssertionError(f"shards [{label}]: rank 0 traced {out['traced']} kernels, its "
                             f"wrappers counted {out['traced_wrapper_counts']} and {rank0}")
    return row


def shard_summary(smi, row):
    print(f"shards summary [{SHARD_K} clients, unsharded] ({smi}): "
          f"{row['unsharded']['ms_per_round_without_capture']:.3f} ms a round of the segmented "
          "run's wall without its captures (graphs replayed; compaction and copies included)")
    for key in ("gloo", "nccl"):
        g = row[key]
        if not isinstance(g, dict):
            print(f"shards summary [NCCL, one rank a card] ({smi}): {g}")
            continue
        a = g["afa_alone"]
        print(f"shards summary [{SHARD_K} clients, {g['ranks']} {g['backend']} ranks] ({smi}): "
              f"ms/round by segment {[round(m, 3) for m in g['ms_per_round_by_segment']]} "
              f"on {g['rows_a_shard']} rows a shard; afa_aggregate alone ({SHARD_AFA_K} rows) "
              f"ms={a['ms']:.3f}, traced {a['trace']['wall_ms']:.3f} ms: "
              + ", ".join(f"{n} {v['ms']:.3f}" for n, v in a["trace"]["kernels"].items())
              + f", all-reduce host {a['trace']['all_reduce_host_ms']:.3f}")


def axis_all_reduces(cfg, steps: int, passes: int) -> dict:
    """The all-reduces one grid round issues on each group (the vmap round
    of a dense model on (data 2, model 2), every 2-D leaf split): a local
    step's forward sums the embedding, each layer's attention (whole heads:
    wo's products; a cut head: also the one gather of q, k and v) and MLP, and
    the loss's max and (sum of exponentials, gold logit); its backward the
    gradient entering each layer's attention (a cut head: also its
    output's) and MLP and the head.  AFA: the row norms, a pass's dots and
    |agg|^2 over ``model``; a pass's weighted sum (a leaf each) and the
    similarities' gather over ``data``, and the final weighted sum."""
    whole = cfg.num_kv_heads % AXIS_GRID["model"] == 0
    attn_fwd, attn_bwd = (1, 1) if whole else (2, 2)
    L, leaves = cfg.num_layers, 12
    step = 1 + L * (attn_fwd + 1) + 2 + L * (attn_bwd + 1) + 1
    return {"model": steps * step + 1 + passes, "data": passes * (leaves + 1) + leaves}


def axis_held(torch, model, cfg, grid, gen):
    """This rank's blocks of the model's weights drawn from ``gen``: their
    shapes against the specs (FSDP as the model's; raises on any other),
    the bytes the draw left allocated, and the bytes the specs give.  The
    gate reads the bytes requested of the caching allocator, which keeps a
    remainder of 1 MiB or less with the block it would split it from, so
    that ``memory_allocated`` may exceed the tensors' bytes by up to 1 MiB
    each."""
    from repro_torch.launch.sharding import shard_bytes, shard_params_tree
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_leaves

    full = build_model(cfg).init(None, "meta")
    specs = shard_params_tree(full, grid, fsdp=model.fsdp)
    def requested():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    torch.cuda.synchronize()
    before, asked = torch.cuda.memory_allocated(), requested()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    asked = requested() - asked
    want, whole = 0, 0
    for leaf, f, spec in zip(tree_leaves(params), tree_leaves(full), tree_leaves(specs)):
        shape = tuple(n // grid.size(e) if e is not None else n
                      for n, e in zip(f.shape, spec + (None,) * (f.ndim - len(spec))))
        if tuple(leaf.shape) != shape:
            raise AssertionError(f"axis: rank {grid.rank} holds {tuple(leaf.shape)} of a "
                                 f"{tuple(f.shape)} leaf, not its {spec} block {shape}")
        want += shard_bytes(tuple(f.shape), f.element_size(), spec, grid)
        whole += f.numel() * f.element_size()
    if asked != want:
        raise AssertionError(f"axis: rank {grid.rank} holds {asked} bytes after the draw "
                             f"({held} allocated); its blocks take {want}")
    return params, specs, {"held_bytes": asked, "allocated_bytes": held, "spec_bytes": want,
                           "whole_bytes": whole}


def axis_compare(torch, grid, got, ref, specs, start=None, steps=None):
    """How far this rank's blocks ``got`` lie outside their bound of the
    one-card ``ref`` (whole leaves on the host, paths as ``specs``), the
    largest over every rank (> 0: outside).  f32 (``start`` None):
    ``AXIS_F32``; bf16: ``TRAIN_ROUNDING`` from the round's start
    ``start``, each leaf's largest update read over its blocks; ``steps``
    (path -> a length) widens a leaf's bound by it (int8: one quantization
    step)."""
    from repro_torch.launch.sharding import take_shard
    from repro_torch.utils.trees import tree_leaves, tree_structure

    frac, ulps = TRAIN_ROUNDING
    worst, diff = float("-inf"), 0.0
    paths = ["/".join(p) for p in tree_structure(got)]
    starts = tree_leaves(start) if start is not None else [None] * len(paths)
    for path, x, spec, z in zip(paths, tree_leaves(got), tree_leaves(specs), starts):
        y = take_shard(ref[path], spec, grid).to(x.device).float()
        x = x.float()
        if start is None:
            rtol, atol = AXIS_F32
        else:
            update = (y - z.float()).abs().max().reshape(1)
            rtol, atol = ulps, frac * float(grid.pmax(grid.pmax(update, "data"), "model")[0])
        atol += 0.0 if steps is None else steps[path]
        worst = max(worst, float(((x - y).abs() - atol - rtol * y.abs()).max()))
        diff = max(diff, float((x - y).abs().max()))
    both = torch.tensor([worst, diff], device=grid.device)
    both = grid.pmax(grid.pmax(both, "data"), "model")
    return float(both[0]), float(both[1])


def axis_round(torch, grid, fed_round, params, rep, n_k, batch):
    """One grid round, timed (host clock to a synchronise), with the
    all-reduces it issued and this rank's peak of allocated memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grid.all_reduces.clear()
    t0 = time.perf_counter()
    agg, rep2, m = fed_round(params, rep, n_k, batch)
    torch.cuda.synchronize()
    return agg, rep2, m, {"ms": (time.perf_counter() - t0) * 1e3,
                          "all_reduces": dict(grid.all_reduces),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "good_frac": float(m["good_frac"]), "afa_rounds": int(m["afa_rounds"]),
                          "alpha": rep2.alpha.tolist(), "beta": rep2.beta.tolist(),
                          "blocked": rep2.blocked.tolist(),
                          "similarities": m["similarities"].tolist()}


def axis_worker(ref_path):
    """One rank of phase N's gloo grid: smollm-135m's weights drawn as this
    rank's blocks, then round 1 in bf16 and on an f32 copy (each against
    the one-card round saved at ``ref_path``) and round 2 in bf16, timed.
    Returns rank 0's numbers and every rank's own."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_grid_mesh, make_test_mesh
    from repro_torch.launch.sharding import batch_pspec, shard_tree
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_apply

    t_worker = time.perf_counter()
    grid = make_grid_mesh(make_test_mesh(**AXIS_GRID), "cuda:0")
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, grid=grid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, specs, held = axis_held(torch, model, cfg, grid, gen)
    _, rounds = train_data(torch, cfg)
    K, r = TRAIN_RUN["K"], TRAIN_RUN

    def rows(batch):
        return shard_tree(batch, grid, tree_apply(lambda t: batch_pspec(
            tuple(t.shape), grid, client_axis=True, per_client_batch=True), batch))

    ref = torch.load(ref_path, map_location="cpu", mmap=True)
    fr_cfg = FedRoundConfig(num_clients=K, local_steps=r["local_steps"], lr=r["lr"],
                            client_axes=("data",))
    n_k = torch.ones((K,), dtype=torch.float32, device="cuda")
    ops.reset_launch_counts()
    out = {"rank": grid.rank, "coords": grid.coords, "held": held}
    fed_round = make_fed_round(model, fr_cfg, grid=grid)
    agg, rep, m, out["bf16"] = axis_round(torch, grid, fed_round, params,
                                          init_reputation(K, device="cuda"), n_k, rows(rounds[0]))
    out["bf16"]["outside"], out["bf16"]["max_abs_diff"] = axis_compare(
        torch, grid, agg, ref["bfloat16"], specs, start=params)
    _, _, _, out["bf16_round2"] = axis_round(torch, grid, fed_round, agg, rep, n_k,
                                             rows(rounds[1]))
    del agg
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    params32 = tree_apply(lambda t: t.float(), params)
    del params
    agg32, _, _, out["f32"] = axis_round(
        torch, grid, make_fed_round(build_model(cfg32, grid=grid), fr_cfg, grid=grid),
        params32, init_reputation(K, device="cuda"), n_k, rows(rounds[0]))
    out["f32"]["outside"], out["f32"]["max_abs_diff"] = axis_compare(
        torch, grid, agg32, ref["float32"], specs)
    out["launches"] = dict(ops.LAUNCH_COUNTS)
    mine = {k: out[k] for k in ("rank", "coords", "held")}
    mine.update({f"{k}_{f}": out[k][f] for k in ("bf16", "f32")
                 for f in ("alpha", "beta", "blocked", "good_frac", "all_reduces", "peak_gb")})
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    out["worker_s"] = time.perf_counter() - t_worker
    return out


def axis_one_card(torch, cfg, params, batch, label):
    """Phase T's vmap round on one card (the grid round's reference): the
    aggregate's leaves by path on the host, the decisions, ms."""
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_leaves, tree_structure

    K, r = TRAIN_RUN["K"], TRAIN_RUN
    fed_round = make_fed_round(build_model(cfg), FedRoundConfig(
        num_clients=K, local_steps=r["local_steps"], lr=r["lr"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg, rep, m = fed_round(params, init_reputation(K, device="cuda"),
                            torch.ones((K,), dtype=torch.float32, device="cuda"), batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    leaves = {"/".join(p): l.cpu() for p, l in zip(tree_structure(agg), tree_leaves(agg))}
    row = {"ms": ms, "good_frac": float(m["good_frac"]), "afa_rounds": int(m["afa_rounds"]),
           "alpha": rep.alpha.tolist(), "beta": rep.beta.tolist(),
           "blocked": rep.blocked.tolist(), "similarities": m["similarities"].tolist()}
    print(f"axis [one card, {label}]: {ms:.1f} ms good_frac={row['good_frac']:.2f} afa_rounds="
          f"{row['afa_rounds']} alpha={row['alpha']}")
    return leaves, row


def model_axis_phase(torch, smi):
    """Phase N: the vmap round on a data x model grid (``make_fed_round(...,
    grid=)``).  smollm-135m on 4 gloo ranks sharing the card against the
    one-card round (bf16 and an f32 copy): every rank's blocks as its specs
    give them (shapes, and the bytes its draw left allocated), the
    aggregates within their bounds, the decisions equal on every rank, the
    all-reduces a round on each group as ``axis_all_reduces`` counts them,
    no kernel launched; ms a round, peak GB a rank.  With four cards or
    more, ``model_axis_cards``.  Returns the rows."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.shards import spawn
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, "cuda")
    _, rounds = train_data(torch, cfg)
    cfg32, params32 = as_f32(cfg, params)
    rows = {"config": dict(arch=TRAIN_ARCH, grid=AXIS_GRID, **TRAIN_RUN)}
    ref = {}
    ref["bfloat16"], rows["one_card_bf16"] = axis_one_card(torch, cfg, params, rounds[0], "bf16")
    ref["float32"], rows["one_card_f32"] = axis_one_card(torch, cfg32, params32, rounds[0], "f32")
    del params, params32
    torch.cuda.empty_cache()
    reckoned = axis_all_reduces(cfg, TRAIN_RUN["local_steps"], rows["one_card_bf16"]["afa_rounds"])
    print(f"axis: reckoned all-reduces a round on (data 2, model 2) gloo ranks: {reckoned} "
          f"(smollm's 3 kv heads over 2 ranks: the gathered-heads route)")
    with tempfile.TemporaryDirectory(prefix="axis_ref_") as tmp:
        path = str(Path(tmp) / "ref.pt")
        torch.save(ref, path)
        del ref
        t0 = time.perf_counter()
        out = spawn(axis_worker, 4, backend="gloo", device="cuda:0", args=(path,))
        rows["spawn_wall_s"] = time.perf_counter() - t0
    rows["grid"] = out
    for dtype, one in (("bf16", rows["one_card_bf16"]), ("f32", rows["one_card_f32"])):
        got = out[dtype]
        print(f"axis [{dtype}, 4 gloo ranks]: {got['ms']:.1f} ms a round (one card "
              f"{one['ms']:.1f}), peak_GB rank 0 {got['peak_gb']:.3f}, outside its bound "
              f"{got['outside']:.3e} (max |diff| {got['max_abs_diff']:.3e}), good_frac="
              f"{got['good_frac']:.2f} afa_rounds={got['afa_rounds']} all-reduces "
              f"{got['all_reduces']}")
        for rank in out["ranks"]:
            for key in ("alpha", "beta", "blocked", "good_frac"):
                if rank[f"{dtype}_{key}"] != one[key]:
                    raise AssertionError(f"axis [{dtype}]: rank {rank['rank']}'s {key} "
                                         f"{rank[f'{dtype}_{key}']} != the one-card {one[key]}")
            if rank[f"{dtype}_all_reduces"] != axis_all_reduces(cfg, TRAIN_RUN["local_steps"],
                                                                 got["afa_rounds"]):
                raise AssertionError(f"axis [{dtype}]: rank {rank['rank']} issued "
                                     f"{rank[f'{dtype}_all_reduces']} all-reduces")
        if got["outside"] > 0:
            raise AssertionError(f"axis [{dtype}]: the grid's aggregate lies {got['outside']} "
                                 "outside its bound of the one-card round")
        if got["good_frac"] != 0.75 or got["alpha"] != [3.0] + [4.0] * 3:
            raise AssertionError(f"axis [{dtype}]: not exactly client 0 screened out: {got}")
    if any(out["launches"].values()):
        raise AssertionError(f"axis: the grid round launched kernels: {out['launches']}")
    for rank in out["ranks"]:
        h = rank["held"]
        print(f"axis: rank {rank['rank']} {rank['coords']} holds {h['held_bytes']} bytes of "
              f"weights (its blocks {h['spec_bytes']}, the whole model {h['whole_bytes']}); "
              f"peak_GB bf16 {rank['bf16_peak_gb']:.3f} f32 {rank['f32_peak_gb']:.3f}")
    print(f"axis: round 2 (bf16) {out['bf16_round2']['ms']:.1f} ms, good_frac="
          f"{out['bf16_round2']['good_frac']:.2f}; worker {out['worker_s']:.1f} s, spawn "
          f"{rows['spawn_wall_s']:.1f} s ({smi})")
    cards = torch.cuda.device_count()
    if cards >= 4:
        rows["cards"] = model_axis_cards(torch, smi)
    else:
        rows["cards"] = f"did not run: {cards} card(s)"
        print(f"axis [{AXIS_BIG_ARCH}, NCCL, one rank a card]: did not run ({cards} card on "
              "this machine)")
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"axis: phase {rows['phase_s']:.1f} s ({smi})")
    return rows


def axis_big_data(torch, cfg, device, run=AXIS_BIG_RUN):
    """``run``'s batches as the train CLI draws them (seed 0): the eval
    batch, then each round's K clients with client 0's attack."""
    import numpy as np

    from repro_torch.data import make_token_stream
    from repro_torch.launch.train import byzantine_batches, make_fed_batches

    r = run
    stream = make_token_stream(vocab=cfg.vocab_size, n=50_000)
    rng = np.random.default_rng(0)
    ev = make_fed_batches(cfg, stream, rng, K=1, S=1, b=r["batch"], seq=r["seq"], device=device)
    rounds = []
    for rnd in range(r["rounds"]):
        batch = make_fed_batches(cfg, stream, rng, K=r["K"], S=r["local_steps"], b=r["batch"],
                                 seq=r["seq"], device=device)
        byzantine_batches(batch, r["byzantine"], rnd, cfg.vocab_size)
        rounds.append(batch)
    return {k: v[0, 0] for k, v in ev.items()}, rounds


def axis_big_worker():
    """One NCCL rank of llama3-8b's grid (one card a rank): this rank's
    blocks drawn (seed 0), ``AXIS_BIG_RUN["rounds"]`` rounds, each with the
    eval loss after it, the last traced on rank 0 (its all-reduces' share:
    the device time of the collective kernels and the host time in the
    grid's all-reduce ranges, against the round's wall)."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
    from repro_torch.launch.mesh import GRID_ALL_REDUCE_RANGE, make_grid_mesh, make_test_mesh
    from repro_torch.launch.sharding import batch_pspec, shard_tree
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_apply

    t_worker = time.perf_counter()
    r = AXIS_BIG_RUN
    grid = make_grid_mesh(make_test_mesh(**AXIS_GRID), "cuda")
    cfg = get_config(AXIS_BIG_ARCH).with_(num_layers=r["layers"])
    model = build_model(cfg, grid=grid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params, _, held = axis_held(torch, model, cfg, grid, gen)
    held["draw_s"] = time.perf_counter() - t0
    eval_batch, rounds = axis_big_data(torch, cfg, grid.device)

    def rows(batch):
        return shard_tree(batch, grid, tree_apply(lambda t: batch_pspec(
            tuple(t.shape), grid, client_axis=True, per_client_batch=True), batch))

    K = r["K"]
    fed_round = make_fed_round(model, FedRoundConfig(
        num_clients=K, local_steps=r["local_steps"], lr=r["lr"], client_axes=("data",)),
        grid=grid)
    rep = init_reputation(K, device=grid.device)
    n_k = torch.ones((K,), dtype=torch.float32, device=grid.device)
    out = {"held": held, "rounds": []}
    for rnd, batch in enumerate(rounds):
        local = rows(batch)
        if rnd == len(rounds) - 1 and grid.rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                params, rep, m, row = axis_round(torch, grid, fed_round, params, rep, n_k, local)
            spans = device_spans(torch, prof)
            nccl = [(b, e, k) for b, e, k in spans if "nccl" in k.lower()]
            host = [e.time_range.end - e.time_range.start for e in prof.events()
                    if e.name == GRID_ALL_REDUCE_RANGE and e.device_type == DeviceType.CPU]
            row["trace"] = {"wall_ms": row["ms"], "device_busy_ms": busy_us(spans) / 1e3,
                            "collective_device_ms": busy_us(nccl) / 1e3,
                            "collective_kernels": len(nccl),
                            "all_reduce_host_ms": sum(host) / 1e3, "all_reduce_ranges": len(host)}
        else:
            params, rep, m, row = axis_round(torch, grid, fed_round, params, rep, n_k, local)
        with torch.no_grad():
            row["eval_loss"] = float(model.loss_fn(params, eval_batch)[0])
        out["rounds"].append(row)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"rank": grid.rank, "held": held, "rounds": [
        {k: x[k] for k in ("alpha", "beta", "blocked", "good_frac", "eval_loss", "peak_gb",
                           "ms")} for x in out["rounds"]]})
    out["ranks"] = ranks
    out["worker_s"] = time.perf_counter() - t_worker
    return out


def axis_one_layer_worker():
    """One NCCL rank, a (data 1, model 1) grid: llama3-8b with one layer,
    the grid's round and the one-card round on the same weights and
    batches; True where every aggregate leaf and the posteriors are the
    same bits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
    from repro_torch.launch.mesh import make_grid_mesh, make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_leaves

    r = AXIS_BIG_RUN
    grid = make_grid_mesh(make_test_mesh(data=1, model=1), "cuda")
    cfg = get_config(AXIS_BIG_ARCH).with_(num_layers=1)
    model = build_model(cfg, grid=grid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen, "cuda")
    _, rounds = axis_big_data(torch, cfg, grid.device)
    cfg_round = FedRoundConfig(num_clients=r["K"], local_steps=r["local_steps"], lr=r["lr"])
    runs = []
    for g in (grid, None):
        agg, rep, _ = make_fed_round(model, cfg_round, grid=g)(
            params, init_reputation(r["K"], device="cuda"),
            torch.ones((r["K"],), dtype=torch.float32, device="cuda"), rounds[0])
        runs.append(([l.cpu() for l in tree_leaves(agg)], rep))
        del agg
    (a, ra), (b, rb) = runs
    return (all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(ra.alpha, rb.alpha)
            and torch.equal(ra.beta, rb.beta) and torch.equal(ra.blocked, rb.blocked))


def model_axis_cards(torch, smi):
    """llama3-8b on a (data 2, model 2) grid of one NCCL rank a card: the
    bytes reckoned first, then ``axis_big_worker``'s rounds: losses finite,
    exactly client 0 screened out each round, the same posteriors on every
    rank; ms a round, peak GB a rank, the traced round's all-reduce share;
    and ``axis_one_layer_worker``'s bit-for-bit check."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shards import spawn
    from repro_torch.launch.sharding import shard_bytes, shard_params_tree
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_leaves

    r = AXIS_BIG_RUN
    cfg = get_config(AXIS_BIG_ARCH).with_(num_layers=r["layers"])
    grid = make_test_mesh(**AXIS_GRID)
    full = build_model(cfg).init(None, "meta")
    specs = shard_params_tree(full, grid)
    base = sum(shard_bytes(tuple(f.shape), f.element_size(), s, grid)
               for f, s in zip(tree_leaves(full), tree_leaves(specs)))
    clients = r["K"] // grid.size("data")
    # a client's proposal, momentum and gradient: three copies of the blocks
    reckoned = base + clients * 3 * base
    print(f"axis [{AXIS_BIG_ARCH}, {r['layers']} layers]: reckoned a rank: base weights "
          f"{base / 1e9:.2f} GB + {clients} clients x 3 x {base / 1e9:.2f} GB = "
          f"{reckoned / 1e9:.2f} GB before activations and AFA's transients")
    t0 = time.perf_counter()
    out = spawn(axis_big_worker, 4, backend="nccl", device="cuda")
    row = {"layers": r["layers"], "reckoned_gb": reckoned / 1e9, "base_gb": base / 1e9,
           "spawn_wall_s": time.perf_counter() - t0, "rank0": out}
    K = r["K"]
    for n, rr in enumerate(out["rounds"], start=1):
        print(f"axis [{AXIS_BIG_ARCH} NCCL] round {n}: {rr['ms']:.1f} ms peak_GB rank 0 "
              f"{rr['peak_gb']:.2f} eval_loss={rr['eval_loss']:.4f} good_frac="
              f"{rr['good_frac']:.2f} afa_rounds={rr['afa_rounds']} all-reduces "
              f"{rr['all_reduces']} similarities {[round(x, 4) for x in rr['similarities']]}")
        for rank in out["ranks"]:
            x = rank["rounds"][n - 1]
            if (x["alpha"] != [3.0] + [3.0 + n] * (K - 1) or x["beta"] != [3.0 + n] + [3.0] * (K - 1)
                    or any(x["blocked"]) or x["good_frac"] != 0.75):
                raise AssertionError(f"axis [{AXIS_BIG_ARCH}]: rank {rank['rank']} round {n}: "
                                     f"not exactly client 0 screened out: {x}")
            if not all(map(lambda v: v == v and abs(v) != float("inf"),
                           [x["eval_loss"]] + rr["similarities"])):
                raise AssertionError(f"axis [{AXIS_BIG_ARCH}]: rank {rank['rank']} round {n}: "
                                     f"a loss or similarity not finite: {x}")
    t = out["rounds"][-1]["trace"]
    print(f"axis [{AXIS_BIG_ARCH} NCCL] traced round on rank 0: wall {t['wall_ms']:.1f} ms, "
          f"device busy {t['device_busy_ms']:.1f} ms, collective kernels {t['collective_kernels']}"
          f" taking {t['collective_device_ms']:.1f} ms on the device (share of the wall "
          f"{t['collective_device_ms'] / t['wall_ms']:.4f}), host in {t['all_reduce_ranges']} "
          f"all-reduce ranges {t['all_reduce_host_ms']:.1f} ms ({smi})")
    for rank in out["ranks"]:
        h = rank["held"]
        print(f"axis [{AXIS_BIG_ARCH} NCCL]: rank {rank['rank']} holds {h['held_bytes']} bytes "
              f"(its blocks {h['spec_bytes']}, the model {h['whole_bytes']}), peak_GB "
              f"{max(x['peak_gb'] for x in rank['rounds']):.2f}")
    t0 = time.perf_counter()
    row["one_layer_bit_for_bit"] = spawn(axis_one_layer_worker, 1, backend="nccl", device="cuda")
    print(f"axis [{AXIS_BIG_ARCH}, 1 layer, (data 1, model 1) grid, one NCCL rank]: = the one-card "
          f"round bit for bit: {row['one_layer_bit_for_bit']} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not row["one_layer_bit_for_bit"]:
        raise AssertionError("axis: the (data 1, model 1) grid's round differs from one card's")
    return row


def model_axis_summary(smi, rows):
    """phase N's lines with the card's name and power limit."""
    g = rows["grid"]
    for dtype in ("bf16", "f32"):
        got, one = g[dtype], rows[f"one_card_{dtype}"]
        print(f"axis summary [{TRAIN_ARCH} {dtype} K={TRAIN_RUN['K']}, (data 2, model 2) gloo "
              f"ranks on one card] ({smi}): ms/round={got['ms']:.1f} (one card {one['ms']:.1f}) "
              f"peak_GB a rank={max(r[f'{dtype}_peak_gb'] for r in g['ranks']):.3f} outside="
              f"{got['outside']:.3e} all-reduces {got['all_reduces']}")
    print(f"axis summary [{TRAIN_ARCH} bf16 round 2] ({smi}): ms/round="
          f"{g['bf16_round2']['ms']:.1f}; phase {rows['phase_s']:.1f} s")
    c = rows["cards"]
    if not isinstance(c, dict):
        print(f"axis summary [{AXIS_BIG_ARCH}, NCCL] ({smi}): {c}")
        return
    last = c["rank0"]["rounds"][-1]
    print(f"axis summary [{AXIS_BIG_ARCH} bf16 {c['layers']} layers, (data 2, model 2) NCCL] "
          f"({smi}): ms/round={[round(x['ms'], 1) for x in c['rank0']['rounds']]} peak_GB a rank="
          f"{max(max(x['peak_gb'] for x in r['rounds']) for r in c['rank0']['ranks']):.2f} "
          f"(reckoned {c['reckoned_gb']:.2f} before activations) all-reduce device share="
          f"{last['trace']['collective_device_ms'] / last['trace']['wall_ms']:.4f}")


def fsdp_runs():
    """Phase E's one-card half: (key, config, modes, fsdp) of each model
    run on the gloo grid."""
    from repro_torch.configs import get_config

    moe = get_config(FSDP_MOE_ARCH).with_(num_layers=FSDP_MOE_LAYERS, param_dtype="float32",
                                          compute_dtype="float32")
    return [(TRAIN_ARCH, get_config(TRAIN_ARCH).with_(fed_mode="scan", num_layers=FSDP_LAYERS),
             FSDP_MODES, True),
            (f"{FSDP_MOE_ARCH}/vmap", moe.with_(fed_mode="vmap"),
             {"vmap": FSDP_MOE_MODES["vmap"]}, False),
            (f"{FSDP_MOE_ARCH}/scan", moe.with_(fed_mode="scan"),
             {"scan": FSDP_MOE_MODES["scan"]}, True)]


def fsdp_reckoning(cfg, mode: str, pdt: str, K: int) -> dict:
    """A rank's bytes (GB) in an FSDP round of ``cfg`` on a (data 2, model 2)
    grid, from the specs (meta): ``blocks``, its blocks of the weights;
    ``gathered``, the model's half of the leaves a forward saves for its
    backward (each data-split leaf whole over data; the embedding's gather
    is dropped after the lookup); ``store`` (scan: the K proposals' blocks
    in the storage dtype) or ``acc`` (remat: a float32 accumulator of the
    blocks); ``train``, a client's weights, momentum and gradient (three
    copies of the blocks); ``transient``, three copies of the largest leaf
    one use gathers (a layer's, not the stack's): the gathered vector, its
    cut and a transposed copy.  ``peak`` is their sum with the round's
    start weights."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import shard_bytes, shard_params_tree, uses_axis
    from repro_torch.models import build_model
    from repro_torch.utils.trees import tree_leaves, tree_structure

    grid = make_test_mesh(**AXIS_GRID)
    full = build_model(cfg).init(None, "meta")
    specs = shard_params_tree(full, grid, fsdp=True)
    blocks = gathered = big = 0
    for path, f, spec in zip(tree_structure(full), tree_leaves(full), tree_leaves(specs)):
        b = shard_bytes(tuple(f.shape), f.element_size(), spec, grid)
        g = b * (grid.size("data") if uses_axis(spec, "data") else 1)
        blocks += b
        big = max(big, g // (cfg.num_layers if path[0] == "layers" else 1))
        if path != ("embed",):
            gathered += g
    if mode == "scan":
        extra = {"store": K * blocks * {"int8": 1, "bfloat16": 2, "float32": 4}[pdt] // 2}
    else:
        extra = {"acc": 2 * blocks}
    out = {"params": sum(f.numel() for f in tree_leaves(full)), "blocks": blocks,
           "gathered": gathered, **extra, "train": 3 * blocks, "transient": 3 * big}
    out = {k: v if k == "params" else v / 1e9 for k, v in out.items()}
    out["peak"] = out["blocks"] + sum(v for k, v in out.items()
                                      if k not in ("params", "blocks", "peak"))
    return out


def fsdp_round(torch, grid, fed_round, params, rep, n_k, batch):
    """``axis_round`` with the grid's all-gathers and reduce-scatters."""
    grid.clear_counts()
    agg, rep2, m, row = axis_round(torch, grid, fed_round, params, rep, n_k, batch)
    row.update(all_gathers=dict(grid.all_gathers), reduce_scatters=dict(grid.reduce_scatters))
    return agg, rep2, m, row


def fsdp_scales(torch, grid, scales, ref, w):
    """The int8 scales of this rank: the same bits on every rank, and how
    far they lie outside ``FSDP_SCALE`` of the one-card scales ``ref``
    (``w``: this rank's blocks of the round's start, whose largest
    magnitude over the leaf sets the ulp term); > 0: outside."""
    from repro_torch.utils.trees import tree_leaves, tree_structure

    frac, ulps = FSDP_SCALE
    paths = list(scales)
    s = torch.stack([scales[p] for p in paths])
    hi = grid.pmax(grid.pmax(s, "data"), "model")
    lo = -grid.pmax(grid.pmax(-s, "data"), "model")
    same = bool(torch.equal(hi, s) and torch.equal(lo, s))
    top = dict(zip(["/".join(p) for p in tree_structure(w)],
                   [l.float().abs().max().reshape(1) for l in tree_leaves(w)]))
    worst = float("-inf")
    for path in paths:
        wmax = float(grid.pmax(grid.pmax(top[path], "data"), "model")[0])
        want = ref[path].to(s.device)
        far = (scales[path] - want).abs() - frac * want - ulps * wmax / 127.0
        worst = max(worst, float(far.max()))
    return same, worst


def fsdp_steps(scales) -> dict:
    """One quantization step of each leaf: its largest scale."""
    return {p: float(s.max()) for p, s in scales.items()}


def fsdp_fed_config(mode, pdt, max_rounds, K, local_steps, lr, client_axes=None):
    from repro_torch.core import AFAConfig
    from repro_torch.fed.distributed import FedRoundConfig

    return FedRoundConfig(num_clients=K, local_steps=local_steps, lr=lr,
                          afa=AFAConfig(max_rounds=max_rounds), mode=mode, proposal_dtype=pdt,
                          client_axes=client_axes)


def fsdp_one_card(torch, model, params, batch, modes) -> tuple:
    """The one-card rounds of ``modes`` (label -> (mode, proposal dtype, AFA
    max_rounds)) on phase T's batch: each aggregate's leaves by path on the
    host, the decisions, the int8 scales, ms."""
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round
    from repro_torch.utils.trees import tree_leaves, tree_structure

    K, r = TRAIN_RUN["K"], TRAIN_RUN
    refs, rows = {}, {}
    for label, (mode, pdt, max_rounds) in modes.items():
        fed_round = make_fed_round(model, fsdp_fed_config(mode, pdt, max_rounds, K,
                                                          r["local_steps"], r["lr"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        agg, rep, m = fed_round(params, init_reputation(K, device="cuda"),
                                torch.ones((K,), dtype=torch.float32, device="cuda"), batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        refs[label] = {"agg": {"/".join(p): l.cpu() for p, l in
                               zip(tree_structure(agg), tree_leaves(agg))},
                       "scales": {p: v.cpu() for p, v in m.get("scales", {}).items()}}
        rows[label] = {"ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "good_frac": float(m["good_frac"]), "afa_rounds": int(m["afa_rounds"]),
                       "alpha": rep.alpha.tolist(), "beta": rep.beta.tolist(),
                       "blocked": rep.blocked.tolist(),
                       "similarities": m["similarities"].tolist()}
        del agg, m
        print(f"fsdp [one card, {model.config.name} {label}]: {ms:.1f} ms good_frac="
              f"{rows[label]['good_frac']:.2f} afa_rounds={rows[label]['afa_rounds']} "
              f"alpha={rows[label]['alpha']}")
    return refs, rows


def fsdp_grid_model(torch, grid, cfg, modes, ref, batch, rows_of, tag):
    """This rank's blocks of ``cfg`` (drawn from seed 0; FSDP as its
    ``fed_mode`` asks) and one grid round of each of ``modes`` against the
    one-card round's ``ref``: the row of each, and every rank's
    decisions."""
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round
    from repro_torch.models import build_model

    K, r = TRAIN_RUN["K"], TRAIN_RUN
    model = build_model(cfg, grid=grid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, specs, held = axis_held(torch, model, cfg, grid, gen)
    n_k = torch.ones((K,), dtype=torch.float32, device="cuda")
    out, mine = {"held": held}, {"held": held}
    for label, (mode, pdt, max_rounds) in modes.items():
        axes = ("data",) if mode == "vmap" else None
        fed_round = make_fed_round(model, fsdp_fed_config(mode, pdt, max_rounds, K,
                                                          r["local_steps"], r["lr"], axes),
                                   grid=grid)
        agg, _, m, row = fsdp_round(torch, grid, fed_round, params,
                                    init_reputation(K, device="cuda"), n_k, rows_of(batch, mode))
        want = ref[label]
        steps = fsdp_steps(want["scales"]) if want["scales"] else None
        f32 = cfg.param_dtype == "float32"   # AXIS_F32, else TRAIN_ROUNDING from the start
        row["outside"], row["max_abs_diff"] = axis_compare(
            torch, grid, agg, want["agg"], specs, start=None if f32 else params, steps=steps)
        if "scales" in m:
            row["scales_same_on_every_rank"], row["scales_outside"] = fsdp_scales(
                torch, grid, m["scales"], want["scales"], params)
        del agg, m
        out[label] = row
        mine[label] = {k: row[k] for k in ("alpha", "beta", "blocked", "good_frac", "afa_rounds",
                                           "peak_gb", "all_reduces", "all_gathers",
                                           "reduce_scatters", "ms")}
        if grid.rank == 0:
            print(f"fsdp [{tag} {label}, rank 0]: {row['ms']:.1f} ms", flush=True)
    return out, mine


def fsdp_worker(ref_path):
    """One rank of phase E's gloo grid: smollm-135m under FSDP in each of
    ``FSDP_MODES``, then olmoe-1b-7b (cut) in each of ``FSDP_MOE_MODES``,
    against the one-card rounds saved at ``ref_path``.  Returns rank 0's
    rows and every rank's own."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_grid_mesh, make_test_mesh
    from repro_torch.launch.sharding import batch_pspec, shard_tree
    from repro_torch.models.model import tree_apply

    t_worker = time.perf_counter()
    grid = make_grid_mesh(make_test_mesh(**AXIS_GRID), "cuda:0")
    ref = torch.load(ref_path, map_location="cpu", mmap=True)

    def rows_of(batch, mode):
        # vmap: this rank's client rows; FSDP: the whole batch, whose rows
        # the model splits over data
        if mode != "vmap":
            return batch
        return shard_tree(batch, grid, tree_apply(lambda t: batch_pspec(
            tuple(t.shape), grid, client_axis=True, per_client_batch=True), batch))

    ops.reset_launch_counts()
    out, mine = {"rank": grid.rank, "coords": grid.coords}, {"rank": grid.rank}
    for key, cfg, modes, _ in fsdp_runs():
        _, rounds = train_data(torch, cfg)
        out[key], mine[key] = fsdp_grid_model(torch, grid, cfg, modes, ref[key], rounds[0],
                                              rows_of, key)
        del rounds
        torch.cuda.empty_cache()
    out["launches"] = dict(ops.LAUNCH_COUNTS)
    mine["launches"] = out["launches"]
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    out["worker_s"] = time.perf_counter() - t_worker
    return out


def fsdp_phase(torch, smi):
    """Phase E: FSDP for scan and remat, and MoE expert parallelism, on a
    (data 2, model 2) grid.  smollm-135m and olmoe-1b-7b (cut) on 4 gloo
    ranks sharing the card against their one-card rounds (``fsdp_runs``):
    the decisions equal on every rank, every rank holding only its specs'
    blocks (shapes, and the bytes its draw left allocated), the aggregates
    within their bounds, the int8 scales the same on every rank and within
    ``FSDP_SCALE`` of one card's, no kernel launched on any rank; ms a
    round, peak GB a rank, the collectives a round by group.  With four
    cards or more, ``fsdp_cards``.  Returns the rows."""
    import tempfile

    from repro_torch.launch.shards import spawn
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rows = {"config": dict(grid=AXIS_GRID, layers=FSDP_LAYERS, moe_layers=FSDP_MOE_LAYERS,
                           **TRAIN_RUN),
            "one_card": {}}
    ref = {}
    for key, cfg, modes, _ in fsdp_runs():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        model = build_model(cfg)
        params = model.init(gen, "cuda")
        _, rounds = train_data(torch, cfg)
        ref[key], rows["one_card"][key] = fsdp_one_card(torch, model, params, rounds[0], modes)
        del params, rounds
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="fsdp_ref_") as tmp:
        path = str(Path(tmp) / "ref.pt")
        torch.save(ref, path)
        del ref
        t0 = time.perf_counter()
        out = spawn(fsdp_worker, 4, backend="gloo", device="cuda:0", args=(path,))
        rows["spawn_wall_s"] = time.perf_counter() - t0
    rows["grid"] = out
    for key, _, modes, fsdp in fsdp_runs():
        for label in modes:
            got, one = out[key][label], rows["one_card"][key][label]
            print(f"fsdp [{key} {label}, 4 gloo ranks{', FSDP' if fsdp else ''}]: "
                  f"{got['ms']:.1f} ms a round (one card {one['ms']:.1f}), peak_GB rank 0 "
                  f"{got['peak_gb']:.3f}, outside its bound {got['outside']:.3e} (max |diff| "
                  f"{got['max_abs_diff']:.3e}), good_frac={got['good_frac']:.2f} afa_rounds="
                  f"{got['afa_rounds']}; all-reduces {got['all_reduces']} all-gathers "
                  f"{got['all_gathers']} reduce-scatters {got['reduce_scatters']}")
            for rank in out["ranks"]:
                mine = rank[key][label]
                for field in ("alpha", "beta", "blocked", "good_frac", "afa_rounds"):
                    if mine[field] != one[field]:
                        raise AssertionError(f"fsdp [{key} {label}]: rank {rank['rank']}'s "
                                             f"{field} {mine[field]} != the one-card {one[field]}")
            if got["outside"] > 0:
                raise AssertionError(f"fsdp [{key} {label}]: the grid's aggregate lies "
                                     f"{got['outside']} outside its bound of the one-card round")
            if got["good_frac"] != 0.75 or got["alpha"] != [3.0] + [4.0] * 3:
                raise AssertionError(f"fsdp [{key} {label}]: not exactly client 0 screened out: "
                                     f"{got}")
            if "scales_outside" in got:
                print(f"fsdp [{key} {label}]: int8 scales the same bits on every rank: "
                      f"{got['scales_same_on_every_rank']}, outside FSDP_SCALE of one card's "
                      f"{got['scales_outside']:.3e}")
                if not got["scales_same_on_every_rank"] or got["scales_outside"] > 0:
                    raise AssertionError(f"fsdp [{key} {label}]: the int8 scales are not the "
                                         "whole leaf's")
            if fsdp and not got["all_gathers"]:
                raise AssertionError(f"fsdp [{key} {label}]: no all-gather: nothing was FSDP'd")
        for rank in out["ranks"]:
            h = rank[key]["held"]
            print(f"fsdp [{key}]: rank {rank['rank']} holds {h['held_bytes']} bytes of weights "
                  f"(its blocks {h['spec_bytes']}, the whole model {h['whole_bytes']}), peak_GB "
                  + " ".join(f"{label} {rank[key][label]['peak_gb']:.3f}" for label in modes))
    for rank in out["ranks"]:
        if any(rank["launches"].values()):
            raise AssertionError(f"fsdp: rank {rank['rank']} launched kernels: "
                                 f"{rank['launches']}")
    print(f"fsdp: worker {out['worker_s']:.1f} s, spawn {rows['spawn_wall_s']:.1f} s ({smi})")
    cards = torch.cuda.device_count()
    if cards >= 4:
        rows["cards"] = fsdp_cards(torch, smi)
    else:
        rows["cards"] = f"did not run: {cards} card(s)"
        print(f"fsdp [{', '.join(FSDP_BIG)}, NCCL, one rank a card]: did not run ({cards} card "
              "on this machine)")
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"fsdp: phase {rows['phase_s']:.1f} s ({smi})")
    return rows


def fsdp_big_worker(arch):
    """One NCCL rank of ``arch``'s FSDP grid (one card a rank), cut to its
    ``FSDP_BIG`` depth: this rank's blocks drawn (seed 0), the eval loss,
    then ``FSDP_BIG_RUN["rounds"]`` rounds, each with the eval loss after
    it, the last traced on rank 0 (the collectives' share: the device time
    of the NCCL kernels and the host time in the grid's collective ranges,
    against the round's wall)."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round
    from repro_torch.launch.mesh import (
        GRID_ALL_GATHER_RANGE,
        GRID_ALL_REDUCE_RANGE,
        GRID_REDUCE_SCATTER_RANGE,
        make_grid_mesh,
        make_test_mesh,
    )
    from repro_torch.models import build_model

    t_worker = time.perf_counter()
    mode, pdt, max_rounds, K, layers = FSDP_BIG[arch]
    run = dict(FSDP_BIG_RUN, K=K)
    grid = make_grid_mesh(make_test_mesh(**AXIS_GRID), "cuda")
    cfg = get_config(arch).with_(num_layers=layers, fed_mode=mode)
    model = build_model(cfg, grid=grid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params, _, held = axis_held(torch, model, cfg, grid, gen)
    held["draw_s"] = time.perf_counter() - t0
    eval_batch, rounds = axis_big_data(torch, cfg, grid.device, run)
    rep = init_reputation(K, device=grid.device)
    n_k = torch.ones((K,), dtype=torch.float32, device=grid.device)
    with torch.no_grad():
        out = {"held": held, "eval_loss_0": float(model.loss_fn(params, eval_batch)[0]),
               "rounds": []}
    fed_round = make_fed_round(model, fsdp_fed_config(mode, pdt, max_rounds, K,
                                                      run["local_steps"], run["lr"]), grid=grid)
    if arch in FSDP_BIG_PROBE:   # reported, not gated; then the experts at their fan-in
        agg, _, m, row = fsdp_round(torch, grid, fed_round, params, rep, n_k, rounds[0])
        with torch.no_grad():
            row["eval_loss"] = float(model.loss_fn(agg, eval_batch)[0])
        row["eval_loss_0"] = out["eval_loss_0"]
        out["probe"] = row
        del agg, m
        with torch.no_grad():
            for name in ("gate", "up", "down"):
                w = params["layers"]["moe"][name]   # (L, E / model, d_in, d_out / data)
                w.mul_((cfg.num_experts / (cfg.d_ff if name == "down" else cfg.d_model)) ** 0.5)
            out["eval_loss_0"] = float(model.loss_fn(params, eval_batch)[0])
    ranges = (GRID_ALL_REDUCE_RANGE, GRID_ALL_GATHER_RANGE, GRID_REDUCE_SCATTER_RANGE)
    for rnd, batch in enumerate(rounds):
        if rnd == len(rounds) - 1 and grid.rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                params, rep, m, row = fsdp_round(torch, grid, fed_round, params, rep, n_k, batch)
            spans = device_spans(torch, prof)
            nccl = [(b, e, k) for b, e, k in spans if "nccl" in k.lower()]
            host = [e.time_range.end - e.time_range.start for e in prof.events()
                    if e.name in ranges and e.device_type == DeviceType.CPU]
            row["trace"] = {"wall_ms": row["ms"], "device_busy_ms": busy_us(spans) / 1e3,
                            "collective_device_ms": busy_us(nccl) / 1e3,
                            "collective_kernels": len(nccl),
                            "collective_host_ms": sum(host) / 1e3, "collective_ranges": len(host)}
            del prof
        else:
            params, rep, m, row = fsdp_round(torch, grid, fed_round, params, rep, n_k, batch)
        if "scales" in m:
            s = torch.stack(list(m["scales"].values()))
            same = torch.equal(grid.pmax(grid.pmax(s, "data"), "model"), s) and torch.equal(
                -grid.pmax(grid.pmax(-s, "data"), "model"), s)
            row["scales_same_on_every_rank"] = bool(same)
        del m
        with torch.no_grad():
            row["eval_loss"] = float(model.loss_fn(params, eval_batch)[0])
        out["rounds"].append(row)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"rank": grid.rank, "held": held, "rounds": [
        {k: x[k] for k in ("alpha", "beta", "blocked", "good_frac", "eval_loss", "peak_gb", "ms")
         + (("scales_same_on_every_rank",) if "scales_same_on_every_rank" in x else ())}
        for x in out["rounds"]]})
    out["ranks"] = ranks
    out["worker_s"] = time.perf_counter() - t_worker
    return out


def fsdp_cards(torch, smi):
    """``FSDP_BIG`` on a (data 2, model 2) grid of one NCCL rank a card:
    the bytes reckoned first (``fsdp_reckoning``), then ``fsdp_big_worker``'s
    rounds: exactly client 0 screened out each round on every rank, the
    eval losses finite and falling, the int8 scales the same on every rank;
    ms a round, peak GB a rank, the collectives a round, the traced round's
    collective share.  Returns the rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shards import spawn

    rows, failed = {}, []
    for arch, (mode, pdt, _, K, layers) in FSDP_BIG.items():
        cfg = get_config(arch).with_(num_layers=layers)
        reck = fsdp_reckoning(cfg, mode, pdt, K)
        print(f"fsdp [{arch}, {layers} of {get_config(arch).num_layers} layers, {mode} {pdt}, "
              f"K={K}]: reckoned a rank (GB): "
              + ", ".join(f"{k} {v:.2f}" if k != "params" else f"{k} {v:,}"
                          for k, v in reck.items()), flush=True)
        t0 = time.perf_counter()
        out = spawn(fsdp_big_worker, 4, backend="nccl", device="cuda", args=(arch,))
        row = {"mode": mode, "proposal_dtype": pdt, "K": K, "layers": layers,
               "reckoned": reck, "spawn_wall_s": time.perf_counter() - t0, "rank0": out}
        losses = [out["eval_loss_0"]] + [x["eval_loss"] for x in out["rounds"]]
        if "probe" in out:
            p = out["probe"]
            print(f"fsdp [{arch} NCCL] round 1 on the reference's draw, experts at fan-in E "
                  f"(reported, not gated): {p['ms']:.1f} ms good_frac={p['good_frac']:.3f} "
                  f"eval_loss {p['eval_loss_0']:.4f} -> {p['eval_loss']:.4f} similarities "
                  f"{[f'{x:.9f}' for x in p['similarities']]}; then the experts at their "
                  "fan-in:", flush=True)
        for n, rr in enumerate(out["rounds"], start=1):
            print(f"fsdp [{arch} NCCL] round {n}: {rr['ms']:.1f} ms peak_GB rank 0 "
                  f"{rr['peak_gb']:.2f} eval_loss={rr['eval_loss']:.4f} good_frac="
                  f"{rr['good_frac']:.3f} afa_rounds={rr['afa_rounds']} all-reduces "
                  f"{rr['all_reduces']} all-gathers {rr['all_gathers']} reduce-scatters "
                  f"{rr['reduce_scatters']} similarities "
                  f"{[f'{x:.9f}' for x in rr['similarities']]}", flush=True)
            for rank in out["ranks"]:
                x = rank["rounds"][n - 1]
                if (x["alpha"] != [3.0] + [3.0 + n] * (K - 1)
                        or x["beta"] != [3.0 + n] + [3.0] * (K - 1) or any(x["blocked"])
                        or x["good_frac"] != (K - 1) / K):
                    failed.append(f"fsdp [{arch}]: rank {rank['rank']} round {n}: not exactly "
                                  f"client 0 screened out: {x}")
                if not x.get("scales_same_on_every_rank", True):
                    failed.append(f"fsdp [{arch}]: rank {rank['rank']} round {n}: the int8 "
                                  "scales differ between the ranks")
        if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
            failed.append(f"fsdp [{arch}]: eval losses not finite and falling: {losses}")
        t = out["rounds"][-1]["trace"]
        print(f"fsdp [{arch} NCCL] eval losses {[round(v, 4) for v in losses]}; traced round on "
              f"rank 0: wall {t['wall_ms']:.1f} ms, device busy {t['device_busy_ms']:.1f} ms, "
              f"{t['collective_kernels']} collective kernels taking "
              f"{t['collective_device_ms']:.1f} ms on the device (share of the wall "
              f"{t['collective_device_ms'] / t['wall_ms']:.4f}), host in "
              f"{t['collective_ranges']} collective ranges {t['collective_host_ms']:.1f} ms "
              f"({smi})", flush=True)
        for rank in out["ranks"]:
            h = rank["held"]
            print(f"fsdp [{arch} NCCL]: rank {rank['rank']} holds {h['held_bytes']} bytes "
                  f"(its blocks {h['spec_bytes']}, the model {h['whole_bytes']}), peak_GB "
                  f"{max(x['peak_gb'] for x in rank['rounds']):.2f} (reckoned "
                  f"{reck['peak']:.2f})")
        rows[arch] = row
    for msg in failed:
        print(msg, flush=True)
    if failed:   # each config ran and printed its rows; any gate missed fails the phase
        raise AssertionError(f"fsdp: {len(failed)} four-card gate(s) missed: {failed[0]}")
    return rows


def fsdp_summary(smi, rows):
    """phase E's lines with the card's name and power limit."""
    g = rows["grid"]
    for key, _, modes, _ in fsdp_runs():
        for label in modes:
            got, one = g[key][label], rows["one_card"][key][label]
            print(f"fsdp summary [{key} {label} K={TRAIN_RUN['K']}, (data 2, model 2) gloo "
                  f"ranks on one card] ({smi}): ms/round={got['ms']:.1f} (one card "
                  f"{one['ms']:.1f}) peak_GB a rank="
                  f"{max(r[key][label]['peak_gb'] for r in g['ranks']):.3f} outside="
                  f"{got['outside']:.3e} all-reduces {got['all_reduces']} all-gathers "
                  f"{got['all_gathers']} reduce-scatters {got['reduce_scatters']}")
    print(f"fsdp summary: phase {rows['phase_s']:.1f} s")
    fsdp_cards_summary(smi, rows["cards"])


def fsdp_cards_summary(smi, c):
    """phase E's four-card lines."""
    if not isinstance(c, dict):
        print(f"fsdp summary [{', '.join(FSDP_BIG)}, NCCL] ({smi}): {c}")
        return
    for arch, row in c.items():
        r0 = row["rank0"]
        t = r0["rounds"][-1]["trace"]
        print(f"fsdp summary [{arch} {row['layers']} layers {row['mode']} {row['proposal_dtype']} "
              f"K={row['K']}, (data 2, model 2) NCCL] ({smi}): ms/round="
              f"{[round(x['ms'], 1) for x in r0['rounds']]} peak_GB a rank="
              f"{max(max(x['peak_gb'] for x in r['rounds']) for r in r0['ranks']):.2f} "
              f"(reckoned {row['reckoned']['peak']:.2f}) collective device share="
              f"{t['collective_device_ms'] / t['wall_ms']:.4f} eval_loss "
              f"{r0['eval_loss_0']:.4f} -> {r0['rounds'][-1]['eval_loss']:.4f}")


def fsdp_only(torch, smi, name, cards_only: bool = False) -> None:
    """``--phase E``: phase E alone (its four-card half where there are four
    cards), its numbers to ``chiprun_out/chip_smoke_fsdp.json``;
    ``--phase E4`` (``cards_only``): the four-card half alone, to
    ``chip_smoke_fsdp_cards.json``."""
    if cards_only:
        if torch.cuda.device_count() < 4:
            fail(f"--phase E4 needs four cards, this machine has {torch.cuda.device_count()}")
        rows = {"cards": fsdp_cards(torch, smi)}
    else:
        rows = fsdp_phase(torch, smi)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"chip_smoke_fsdp{'_cards' if cards_only else ''}.json").write_text(json.dumps(
        {"nvidia_smi": smi, "device": name, "torch": torch.__version__, "fsdp": rows},
        indent=1))
    if cards_only:
        fsdp_cards_summary(smi, rows["cards"])
    else:
        fsdp_summary(smi, rows)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def serve_reckoning(arch: str, global_batch: int) -> dict:
    """A rank's bytes (GB) serving ``arch``'s ``decode_32k`` cut to
    ``global_batch`` sequences on a (data 2, model 2) grid, from the specs
    (meta): ``weights``, its blocks of the weights (no FSDP); ``cache``, its
    ``cache_pspec`` blocks; ``widen``, a decode step's f32 copies of one
    layer's k and v blocks (the step's largest transient); ``logits``, its
    rows' f32 logits over the whole vocabulary and their vocab block.
    ``peak`` is their sum."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import block_shape
    from repro_torch.launch.specs import arg_specs, input_specs, rank_bytes
    from repro_torch.models import build_model

    cfg = get_config(arch)
    grid = make_test_mesh(**AXIS_GRID)
    bundle = input_specs(build_model(cfg), "decode_32k", grid, global_batch=global_batch)
    specs = arg_specs(cfg, bundle, grid)
    k = bundle.args[1]["layers"][0]
    block = block_shape(tuple(k.shape), specs[1]["layers"][0], grid)
    layer = 1
    for n in block[1:]:
        layer *= n
    out = {"weights": rank_bytes(bundle.args[0], specs[0], grid),
           "cache": rank_bytes(bundle.args[1], specs[1], grid),
           "widen": 2 * layer * 4, "logits": block[1] * cfg.vocab_size * 4 * 3 // 2}
    out = {key: v / 1e9 for key, v in out.items()}
    out["peak"] = sum(out.values())
    out["cache_whole"] = sum(t.numel() * t.element_size() for t in leaves(bundle.args[1])) / 1e9
    return out


def teacher_logits(torch, model, params, prompts, tokens, size: int, steps: int):
    """(B, 1 + steps, V) f32 on the host: the prefill's last logits, then
    ``steps`` decode steps fed ``tokens[:, t]`` (the whole batch's; a grid
    model keeps its rows), a linear cache of ``size`` slots."""
    logits, cache = model.prefill(params, {"tokens": prompts}, cache_size=size)
    out = [logits.cpu()]
    for t in range(steps):
        logits, cache = model.decode_step(params, cache, tokens[:, t], cache_size=size)
        out.append(logits.cpu())
    return torch.stack(out, dim=1)


def top2_margin(torch, logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def bf16_bound(torch, want):
    """The bound of bf16 logits held to one card's ``want`` (.., V): each
    row's ``GRID_BF16_REL`` of its largest |logit|; twice it is a
    near-tie."""
    return GRID_BF16_REL * want.abs().amax(-1)


def leaves_one_card_at(torch, label, got, want, margins, bounds) -> list:
    """Each row's first step where greedy tokens ``got`` leave one card's
    ``want`` (None: never); there one card's top-2 margin (``margins``,
    rows x steps) must be below twice its ``bounds``, a near-tie that bf16
    rounding may decide either way (after it each run follows its own
    tokens)."""
    out = []
    for i in range(got.shape[0]):
        differ = (got[i] != want[i]).nonzero()
        at = int(differ[0]) if len(differ) else None
        if at is not None and float(margins[i, at]) > 2 * float(bounds[i, at]):
            raise AssertionError(f"serve [{label}]: row {i} leaves one card's tokens at step {at}"
                                 f" past one card's margin {float(margins[i, at])}")
        out.append(at)
    return out


def grid_olmoe_cfg():
    from repro_torch.configs import get_config

    return get_config(FSDP_MOE_ARCH).with_(num_layers=FSDP_MOE_LAYERS, param_dtype="float32",
                                           compute_dtype="float32", use_pallas_attention=True)


def grid_serve_one_card(torch):
    """Phase R's one-card references: smollm-135m bf16 served by
    ``generate`` (its tokens) and teacher-forced with them (every step's
    logits), the f32 copy teacher-forced for ``GRID_F32_STEPS``, olmoe (cut,
    f32) served and teacher-forced."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg16, p16, _ = smollm_forward_inputs(torch)
    cfg16 = cfg16.with_(use_pallas_attention=True)
    b, p, gen = SERVE_LLM.values()
    prompts = serve_prompts(torch, cfg16.vocab_size, b, p, 2)
    refs = {"prompts": prompts.cpu()}
    with torch.no_grad():
        model = build_model(cfg16)
        res = generate(model, p16, prompts, gen=gen, ring=False, cache_size=p + gen)
        refs["bf16_tokens"], refs["bf16_ms"] = res.tokens.cpu(), res.times
        del res
        refs["bf16"] = teacher_logits(torch, model, p16, prompts, refs["bf16_tokens"].cuda(),
                                      p + gen, gen - 1)
        cfg32, p32 = as_f32(cfg16, p16)
        del p16
        refs["f32"] = teacher_logits(torch, build_model(cfg32), p32, prompts,
                                     refs["bf16_tokens"].cuda(), p + gen, GRID_F32_STEPS)
        del p32
        torch.cuda.empty_cache()
        cfg = grid_olmoe_cfg()
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        model = build_model(cfg)
        params = model.init(g, "cuda")
        ob, op, og = OLMOE_SERVE.values()
        oprompts = serve_prompts(torch, cfg.vocab_size, ob, op, 4)
        res = generate(model, params, oprompts, gen=og, ring=False, cache_size=op + og)
        refs["olmoe_prompts"], refs["olmoe_tokens"] = oprompts.cpu(), res.tokens.cpu()
        refs["olmoe"] = teacher_logits(torch, model, params, oprompts, res.tokens, op + og,
                                       og - 1)
        del params, model, res
    torch.cuda.empty_cache()
    return refs


def grid_served(torch, ops, grid, model, params, prompts, gen: int, size: int, key: str,
                **generate_kw):
    """``generate`` on this rank of the grid: the flash launches (this
    rank's, all in the prefill), the cache's bytes against ``rank_bytes`` of
    the reference's ``cache_pspec`` blocks, the collectives, ms, peak GB."""
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import cache_tree_pspecs
    from repro_torch.launch.specs import rank_bytes
    from repro_torch.models import build_model

    cfg = model.config
    ops.reset_launch_counts()
    grid.clear_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = generate(model, params, prompts, gen=gen, ring=False, cache_size=size, **generate_kw)
    torch.cuda.synchronize()
    whole = build_model(cfg).init_cache(prompts.shape[0], size, device="meta")
    t = res.times
    return res, {
        "tokens": res.tokens.cpu(), "launches": {n: c for n, c in ops.LAUNCH_COUNTS.items() if c},
        "want_launches": {key: cfg.num_layers},
        "cache_bytes": sum(x.numel() * x.element_size() for x in leaves(res.cache)),
        "rank_bytes": rank_bytes(whole, cache_tree_pspecs(whole, grid), grid),
        "all_reduces": dict(grid.all_reduces), "prefill_ms": t["prefill_s"] * 1e3,
        "decode_ms_per_token": t["decode_s"] / t["decode_steps"] * 1e3,
        "capture_s": t["capture_s"], "tokens_per_s": res.tokens.numel() / (
            t["prefill_s"] + t["decode_s"]), "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def grid_teacher(torch, ops, grid, model, params, prompts, tokens, size, steps, key, path):
    """``teacher_logits`` on this rank of the grid, saved to ``path``;
    exactly L launches of ``key`` (the prefill's)."""
    ops.reset_launch_counts()
    logits = teacher_logits(torch, model, params, prompts, tokens, size, steps)
    counts = {n: c for n, c in ops.LAUNCH_COUNTS.items() if c}
    torch.save(logits, path)
    return {"launches": counts, "want_launches": {key: model.config.num_layers}}


def grid_serve_worker(tmp):
    """One rank of phase R's gloo grid: smollm-135m bf16 served and
    teacher-forced, its f32 copy teacher-forced, olmoe (cut, f32) served and
    teacher-forced, fed the one-card tokens saved in ``tmp``; each run's
    logits to ``tmp``.  Returns every rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_grid_mesh, make_test_mesh
    from repro_torch.models import build_model

    t_worker = time.perf_counter()
    grid = make_grid_mesh(make_test_mesh(**AXIS_GRID), "cuda:0")
    ref = torch.load(Path(tmp) / "ref.pt")
    dev = grid.device
    b, p, gen = SERVE_LLM.values()
    prompts, tokens = ref["prompts"].to(dev), ref["bf16_tokens"].to(dev)
    mine = {"rank": grid.rank, "coords": dict(grid.coords), "runs": {}, "teacher": {}}

    def saved(name):
        return str(Path(tmp) / f"{name}.rank{grid.rank}.pt")

    with torch.no_grad():
        cfg16 = get_config("smollm-135m").with_(use_pallas_attention=True)
        model = build_model(cfg16, grid=grid)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = model.init(g, dev)
        res, mine["runs"]["smollm-135m bf16"] = grid_served(
            torch, ops, grid, model, params, prompts, gen, p + gen, "flash_attn_tc")
        del res
        mine["teacher"]["bf16"] = grid_teacher(torch, ops, grid, model, params, prompts, tokens,
                                               p + gen, GRID_TF_STEPS, "flash_attn_tc",
                                               saved("bf16"))
        cfg32, params = as_f32(cfg16, params)
        mine["teacher"]["f32"] = grid_teacher(
            torch, ops, grid, build_model(cfg32, grid=grid), params, prompts, tokens, p + gen,
            GRID_F32_STEPS, "flash_attn", saved("f32"))
        del params
        torch.cuda.empty_cache()
        cfg = grid_olmoe_cfg()
        model = build_model(cfg, grid=grid)
        g.manual_seed(0)
        params = model.init(g, dev)
        ob, op, og = OLMOE_SERVE.values()
        oprompts = ref["olmoe_prompts"].to(dev)
        res, mine["runs"]["olmoe-1b-7b f32"] = grid_served(
            torch, ops, grid, model, params, oprompts, og, op + og, "flash_attn")
        del res
        mine["teacher"]["olmoe"] = grid_teacher(
            torch, ops, grid, model, params, oprompts, ref["olmoe_tokens"].to(dev), op + og,
            og - 1, "flash_attn", saved("olmoe"))
        del params
    mine["worker_s"] = time.perf_counter() - t_worker
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return ranks


def grid_decisions(torch, label, got, want, f32: bool) -> dict:
    """One rank's teacher-forced logits ``got`` (rows, steps, V) against
    one card's ``want`` on the same rows: how far outside their bound (f32:
    the prefill's at ``FWD_TOL``, each step's at ``SERVE_TF_TOL[1]``; bf16:
    ``bf16_bound``), and the greedy decisions, which must agree wherever
    one card's top-2 margin exceeds twice the bf16 bound (f32:
    everywhere)."""
    diff = (got - want).abs().amax(-1)
    margin = top2_margin(torch, want)
    differ = got.argmax(-1) != want.argmax(-1)
    if f32:
        outside = max(beyond(torch, got[:, 0], want[:, 0], FWD_TOL),
                      beyond(torch, got[:, 1:], want[:, 1:], SERVE_TF_TOL[1]))
        wrong = differ
    else:
        bound = bf16_bound(torch, want)
        outside = float((diff - bound).max())
        wrong = differ & (margin > 2 * bound)
    row = {"max_abs_diff": float((got - want).abs().max()), "outside": outside,
           "decisions": differ.numel(), "differ": int(differ.sum()), "wrong": int(wrong.sum()),
           "min_margin": float(margin.min())}
    if outside > 0 or row["wrong"]:
        raise AssertionError(f"serve grid [{label}]: teacher-forced logits {outside:.3e} outside "
                             f"their bound of one card's, or {row['wrong']} decisions differ "
                             f"beyond a near-tie: {row}")
    return row


def serve_grid_phase(torch, ops, smi):
    """Phase R: serving on a (data 2, model 2) grid (see ``GRID_BF16_REL``).
    Returns the rows and the flash launches the ranks counted (summed over
    them).  With four cards or more, ``serve_cards``."""
    import tempfile

    from repro_torch.launch.shards import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    refs = grid_serve_one_card(torch)
    rows = {"config": {"smollm": SERVE_LLM, "olmoe": dict(OLMOE_SERVE, layers=FSDP_MOE_LAYERS),
                       "grid": AXIS_GRID}}
    b1 = refs["bf16_ms"]
    rows["one_card_bf16"] = {"prefill_ms": b1["prefill_s"] * 1e3,
                             "decode_ms_per_token": b1["decode_s"] / b1["decode_steps"] * 1e3}
    launches = {"flash_attn": 0, "flash_attn_tc": 0}
    with tempfile.TemporaryDirectory(prefix="serve_grid_") as tmp:
        torch.save({k: refs[k] for k in ("prompts", "bf16_tokens", "olmoe_prompts",
                                         "olmoe_tokens")}, Path(tmp) / "ref.pt")
        t0 = time.perf_counter()
        ranks = spawn(grid_serve_worker, 4, backend="gloo", device="cuda:0", args=(tmp,))
        rows["spawn_wall_s"] = time.perf_counter() - t0
        rows["ranks"] = []
        for rank in ranks:
            d = rank["coords"]["data"]

            def mine(t):   # this rank's rows of one card's (B, ...) tensor
                half = t.shape[0] // AXIS_GRID["data"]
                return t[d * half:(d + 1) * half]

            sel = {name: rank["runs"][name] for name in ("smollm-135m bf16", "olmoe-1b-7b f32")}
            bf16, moe = sel["smollm-135m bf16"], sel["olmoe-1b-7b f32"]
            toks = bf16.pop("tokens")
            bf16["tokens_equal_one_card"] = bool(torch.equal(toks, mine(refs["bf16_tokens"])))
            bf16["first_differing_step"] = leaves_one_card_at(
                torch, f"smollm-135m bf16 generate rank {rank['rank']}", toks,
                mine(refs["bf16_tokens"]), top2_margin(torch, mine(refs["bf16"])),
                bf16_bound(torch, mine(refs["bf16"])))
            moe["tokens_equal_one_card"] = bool(torch.equal(moe.pop("tokens"),
                                                            mine(refs["olmoe_tokens"])))
            if not moe["tokens_equal_one_card"]:
                raise AssertionError(f"serve grid [olmoe f32]: rank {rank['rank']}'s generated "
                                     "tokens differ from one card's")
            for name, run in list(sel.items()) + list(rank["teacher"].items()):
                if run["launches"] != run["want_launches"]:
                    raise AssertionError(f"serve grid [{name}]: rank {rank['rank']} launched "
                                         f"{run['launches']}, expected {run['want_launches']}")
                for key, n in run["launches"].items():
                    launches[key] += n
            for name, run in sel.items():
                if run["cache_bytes"] != run["rank_bytes"]:
                    raise AssertionError(f"serve grid [{name}]: rank {rank['rank']} holds "
                                         f"{run['cache_bytes']} bytes of cache, its cache_pspec "
                                         f"blocks {run['rank_bytes']}")
            checks = {}
            for name, f32 in (("bf16", False), ("f32", True), ("olmoe", True)):
                got = torch.load(Path(tmp) / f"{name}.rank{rank['rank']}.pt")
                checks[name] = grid_decisions(torch, f"{name} rank {rank['rank']}", got,
                                              mine(refs[name])[:, :got.shape[1]], f32)
            rows["ranks"].append({"rank": rank["rank"], "coords": rank["coords"], "runs": sel,
                                  "teacher": checks, "worker_s": rank["worker_s"]})
    for r in rows["ranks"]:
        for name, run in r["runs"].items():
            print(f"serve grid [{name}, rank {r['rank']} {r['coords']}, 4 gloo ranks on one card] "
                  f"({smi}): prefill_ms={run['prefill_ms']:.1f} decode ms/token (eager)="
                  f"{run['decode_ms_per_token']:.2f} tokens/s={run['tokens_per_s']:.1f} "
                  f"cache {run['cache_bytes']} bytes = rank_bytes; launches {run['launches']}; "
                  f"all-reduces {run['all_reduces']}; peak_GB={run['peak_gb']:.3f}; tokens = one "
                  f"card's {run['tokens_equal_one_card']}"
                  + (f" (each row leaves them at step {run['first_differing_step']}, a "
                     "near-tie; None: never)" if "first_differing_step" in run else ""))
        for name, c in r["teacher"].items():
            beyond_tie = " beyond a near-tie" if name == "bf16" else ""
            print(f"serve grid [{name} teacher-forced, rank {r['rank']}]: max |logit diff| "
                  f"{c['max_abs_diff']:.3e} (outside its bound by {c['outside']:.3e}), "
                  f"{c['differ']} of {c['decisions']} decisions differ, none{beyond_tie} (min "
                  f"margin {c['min_margin']:.3e})")
    rows["launches"] = launches
    cards = torch.cuda.device_count()
    rows["cards"] = serve_cards(torch, smi) if cards >= 4 else f"did not run: {cards} card(s)"
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"serve grid: phase {rows['phase_s']:.1f} s, spawn {rows['spawn_wall_s']:.1f} s; "
          f"flash launches {launches} ({smi})")
    return rows, launches


def cards_one_card(torch, arch: str, params, rows: tuple, global_batch: int):
    """One card's ``decode_32k`` step on ``rows`` of the seeded bundle
    (``input_specs``' cache slabs and tokens, drawn for those rows alone):
    (B, V) f32 logits on the host."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import INPUT_SHAPES, cache_slab
    from repro_torch.models import build_model

    model = build_model(get_config(arch))
    seq = INPUT_SHAPES["decode_32k"]["seq"]
    cache = model.init_cache(len(rows), seq, device="cuda")
    for n, t in enumerate(cache["layers"]):
        for layer in range(t.shape[0]):
            for i, r in enumerate(rows):
                t[layer, i].copy_(cache_slab(tuple(t.shape[2:]), t.dtype, t.device, seed=2,
                                             leaf=n, layer=layer, row=r))
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    tokens = torch.randint(0, model.config.vocab_size, (global_batch,), generator=g,
                           dtype=torch.int32, device="cuda")[list(rows)]
    pos = torch.full((len(rows),), seq - 1, dtype=torch.int32, device="cuda")
    cache["pos"].copy_(pos)
    with torch.no_grad():
        logits = model.decode_step(params, cache, tokens, pos)[0].cpu()
    del cache
    torch.cuda.empty_cache()
    return logits


def cards_refs(torch):
    """The four-card half's one-card references on card 0: each
    ``SERVE_CARDS`` arch's decode step on its sampled rows, and
    ``SERVE_CARDS_GEN``'s greedy tokens with every step's logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    refs = {"decode": {}}
    for arch, (gb, rows) in SERVE_CARDS.items():
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        params = build_model(get_config(arch)).init(g, "cuda")
        t0 = time.perf_counter()
        refs["decode"][arch] = cards_one_card(torch, arch, params, rows, gb)
        print(f"serve cards [{arch}, one card]: decode_32k on rows {rows} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if arch == SERVE_CARDS_GEN["arch"]:
            model = build_model(get_config(arch).with_(use_pallas_attention=True))
            b, p, n = (SERVE_CARDS_GEN[k] for k in ("B", "P", "gen"))
            prompts = serve_prompts(torch, model.config.vocab_size, b, p, 6)
            with torch.no_grad():
                res = generate(model, params, prompts, gen=n, ring=False, cache_size=p + n)
                refs["gen_prompts"], refs["gen_tokens"] = prompts.cpu(), res.tokens.cpu()
                del res
                logits = teacher_logits(torch, model, params, prompts, refs["gen_tokens"].cuda(),
                                        p + n, n - 1)
                refs["gen_margins"] = top2_margin(torch, logits)
                refs["gen_bounds"] = bf16_bound(torch, logits)
                del logits
        del params
        torch.cuda.empty_cache()
    return refs


def cards_decode(torch, grid, arch: str, global_batch: int, sample: tuple):
    """One NCCL rank's ``decode_32k`` of ``arch`` on the grid: the bundle
    from ``input_specs(model, "decode_32k", grid, device="cuda")``, its
    cache's bytes against ``rank_bytes``, the eager ``build_step`` step and
    a captured ``DecodeProgram`` replay from the same state equal bit for
    bit, ms a step (replays, the state restored before each), a traced
    replay's collective share (rank 0), peak GB; the logits of the sampled
    rows this rank holds."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import DecodeProgram
    from repro_torch.launch.specs import INPUT_SHAPES, arg_specs, input_specs, rank_bytes
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build_model

    cfg = get_config(arch)
    model = build_model(cfg, grid=grid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = input_specs(model, "decode_32k", grid, device=grid.device, global_batch=global_batch)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    params, cache, tokens, pos = bundle.args
    whole = input_specs(build_model(cfg), "decode_32k", grid, global_batch=global_batch)
    want = rank_bytes(whole.args[1], arg_specs(cfg, whole, grid)[1], grid)
    held = sum(t.numel() * t.element_size() for t in leaves(cache))
    S, p = bundle.meta["cache_size"], INPUT_SHAPES["decode_32k"]["seq"] - 1
    kv = cache["layers"]
    slots = kv[0].shape[2]
    at = p - (grid.index("model") * slots if slots < S else 0)
    at = min(max(at, 0), slots - 1)
    snap = [t[:, :, at].clone() for t in kv]
    step = build_step(model, bundle)
    prog = DecodeProgram(model, params, cache, ring=False, greedy=True, cache_size=S)

    def restore():
        for t, s in zip(kv, snap):
            t[:, :, at].copy_(s)
        cache["pos"].copy_(pos)
        prog.tok.copy_(tokens)

    def state(logits):
        return [logits.clone(), *(t[:, :, at].clone() for t in kv), cache["pos"].clone()]

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    with torch.no_grad():
        restore()
        grid.clear_counts()
        logits, _ = step(params, cache, tokens, pos)
        eager, collectives = state(logits), dict(grid.all_reduces)
        eager_ms = []
        for _ in range(3):
            restore()
            eager_ms.append(timed(lambda: step(params, cache, tokens, pos)))
        restore()
        prog.capture()
        restore()
        prog.run()
        graph = state(prog.logits)
        replay_ms = []
        for _ in range(SERVE_CARDS_REPLAYS):
            restore()
            replay_ms.append(timed(prog.run))
        restore()
        torch.cuda.synchronize()
        trace_row = None
        if grid.rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                prog.run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w0) * 1e3
            spans = device_spans(torch, prof)
            nccl = [s for s in spans if "nccl" in s[2].lower()]
            trace_row = {"wall_ms": wall, "device_busy_ms": busy_us(spans) / 1e3,
                         "collective_device_ms": busy_us(nccl) / 1e3,
                         "collective_kernels": len(nccl)}
        else:
            prog.run()
            torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(eager, graph))
    r0 = grid.index("data") * tokens.shape[0]
    mine = {r: eager[0][r - r0].cpu() for r in sample if r0 <= r < r0 + tokens.shape[0]}
    ms = median_of(replay_ms)
    row = {"B": global_batch, "rows": tokens.shape[0], "cache_slots_held": slots,
           "cache_bytes": held, "rank_bytes": want, "draw_s": draw_s,
           "graph_equals_eager": same, "finite": bool(torch.isfinite(eager[0]).all()),
           "pos_after": eager[-1].tolist()[:2], "graph_ms_per_step": ms,
           "eager_ms_per_step": median_of(eager_ms), "tokens_per_s": global_batch / (ms / 1e3),
           "capture_s": prog.capture_s, "all_reduces_a_step": collectives,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "trace": trace_row}
    del prog, step, bundle, cache, kv, snap, params, eager, graph
    torch.cuda.empty_cache()
    return row, mine


def serve_cards_worker(ref_path):
    """One NCCL rank of the four-card half: ``cards_decode`` for each
    ``SERVE_CARDS`` arch, then ``SERVE_CARDS_GEN``'s ``generate`` with its
    decode step captured under NCCL.  Returns every rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_grid_mesh, make_test_mesh
    from repro_torch.models import build_model

    t_worker = time.perf_counter()
    grid = make_grid_mesh(make_test_mesh(**AXIS_GRID), "cuda")
    ref = torch.load(ref_path)
    mine = {"rank": grid.rank, "coords": dict(grid.coords), "decode": {}, "sampled": {}}
    for arch, (gb, sample) in SERVE_CARDS.items():
        mine["decode"][arch], mine["sampled"][arch] = cards_decode(torch, grid, arch, gb, sample)
    s = SERVE_CARDS_GEN
    model = build_model(get_config(s["arch"]).with_(use_pallas_attention=True), grid=grid)
    g = torch.Generator(device=grid.device)
    g.manual_seed(0)
    params = model.init(g, grid.device)
    with torch.no_grad():
        res, row = grid_served(torch, ops, grid, model, params, ref["gen_prompts"].to(grid.device),
                               s["gen"], s["P"] + s["gen"], "flash_attn_tc")
    row["captured"] = res.times["capture_s"] > 0
    mine["generate"] = row
    del res, params
    mine["worker_s"] = time.perf_counter() - t_worker
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return ranks


def serve_cards(torch, smi):
    """The four-card half of phase R: the per-rank reckoning
    (``serve_reckoning``), one card's references (``cards_refs``), then
    ``serve_cards_worker`` on one NCCL rank a card: every rank's cache
    exactly its ``cache_pspec`` blocks, each decode step graph = eager bit
    for bit and finite, the sampled rows' logits within ``bf16_bound`` of
    one card's and their greedy decisions equal beyond a near-tie;
    ``generate``'s step captured, L flash launches a rank, its tokens one
    card's up to a near-tie.  Returns the rows."""
    import tempfile

    from repro_torch.launch.shards import spawn

    rows = {"reckoning": {arch: serve_reckoning(arch, gb) for arch, (gb, _) in
                          SERVE_CARDS.items()}}
    for arch, r in rows["reckoning"].items():
        print(f"serve cards [{arch} decode_32k B={SERVE_CARDS[arch][0]}]: reckoned a rank (GB): "
              + ", ".join(f"{k} {v:.2f}" for k, v in r.items()), flush=True)
    t0 = time.perf_counter()
    refs = cards_refs(torch)
    rows["refs_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="serve_cards_") as tmp:
        path = str(Path(tmp) / "ref.pt")
        torch.save({k: refs[k] for k in ("gen_prompts",)}, path)
        t0 = time.perf_counter()
        ranks = spawn(serve_cards_worker, 4, backend="nccl", device="cuda", args=(path,))
        rows["spawn_wall_s"] = time.perf_counter() - t0
    rows["ranks"] = ranks
    for arch, (gb, sample) in SERVE_CARDS.items():
        reck = rows["reckoning"][arch]
        for rank in ranks:
            d = rank["decode"][arch]
            if d["cache_bytes"] != d["rank_bytes"] or not d["graph_equals_eager"] or \
                    not d["finite"] or d["pos_after"] != [32768] * 2:
                raise AssertionError(f"serve cards [{arch}]: rank {rank['rank']}: {d}")
            print(f"serve cards [{arch} decode_32k B={gb}, rank {rank['rank']} {rank['coords']}, "
                  f"NCCL] ({smi}): {d['rows']} rows x {d['cache_slots_held']} slots, cache "
                  f"{d['cache_bytes'] / 1e9:.2f} GB = rank_bytes; ms/step replayed="
                  f"{d['graph_ms_per_step']:.2f} eager={d['eager_ms_per_step']:.2f} "
                  f"tokens/s={d['tokens_per_s']:.0f} capture_s={d['capture_s']:.2f} draw_s="
                  f"{d['draw_s']:.1f} peak_GB={d['peak_gb']:.2f} (reckoned {reck['peak']:.2f}) "
                  f"all-reduces a step {d['all_reduces_a_step']}; graph = eager bit for bit")
            for r, got in rank["sampled"][arch].items():
                want = refs["decode"][arch][sample.index(r)]
                diff = float((got - want).abs().max())
                margin = float(top2_margin(torch, want))
                bound = float(bf16_bound(torch, want))
                agree = int(got.argmax()) == int(want.argmax())
                if diff > bound or (not agree and margin > 2 * bound):
                    raise AssertionError(f"serve cards [{arch}]: row {r} on rank {rank['rank']}: "
                                         f"max |logit diff| {diff} to one card, decision equal "
                                         f"{agree} at margin {margin}")
                print(f"serve cards [{arch}]: row {r} (rank {rank['rank']}) vs one card: max "
                      f"|logit diff| {diff:.3e} (bound {bound:.3e}), greedy decision equal "
                      f"{agree} (margin {margin:.3e})")
        for rank in ranks:
            rank["sampled"].pop(arch)
        t = ranks[0]["decode"][arch]["trace"]
        print(f"serve cards [{arch}] traced replay on rank 0: wall {t['wall_ms']:.2f} ms, device "
              f"busy {t['device_busy_ms']:.2f} ms, {t['collective_kernels']} collective kernels "
              f"{t['collective_device_ms']:.3f} ms (share of the wall "
              f"{t['collective_device_ms'] / t['wall_ms']:.4f}) ({smi})")
    s = SERVE_CARDS_GEN
    want = refs["gen_tokens"]
    for rank in ranks:
        gr = rank["generate"]
        d, half = rank["coords"]["data"], want.shape[0] // AXIS_GRID["data"]
        gr["first_differing_step"] = leaves_one_card_at(
            torch, f"{s['arch']} generate rank {rank['rank']}", gr.pop("tokens"),
            want[d * half:(d + 1) * half], refs["gen_margins"][d * half:(d + 1) * half],
            refs["gen_bounds"][d * half:(d + 1) * half])
        if gr["launches"] != gr["want_launches"] or gr["cache_bytes"] != gr["rank_bytes"] \
                or not gr["captured"]:
            raise AssertionError(f"serve cards [{s['arch']} generate]: rank {rank['rank']}: {gr}")
        print(f"serve cards [{s['arch']} generate B={s['B']} prompt={s['P']} gen={s['gen']}, rank "
              f"{rank['rank']}, NCCL, decode captured] ({smi}): prefill_ms={gr['prefill_ms']:.1f} "
              f"decode ms/token (graph)={gr['decode_ms_per_token']:.3f} tokens/s="
              f"{gr['tokens_per_s']:.1f} capture_s={gr['capture_s']:.2f} launches "
              f"{gr['launches']} peak_GB={gr['peak_gb']:.2f}; tokens leave one card's at steps "
              f"{gr['first_differing_step']} (None: never)")
    return rows


def serve_grid_summary(smi, rows):
    """Phase R's lines with the card's name and power limit."""
    for r in rows["ranks"][:1]:
        for name, run in r["runs"].items():
            print(f"serve grid summary [{name}, (data 2, model 2) gloo ranks on one card] ({smi}): "
                  f"prefill_ms={run['prefill_ms']:.1f} decode ms/token (eager)="
                  f"{run['decode_ms_per_token']:.2f} tokens/s={run['tokens_per_s']:.1f} "
                  f"(one card bf16 decode {rows['one_card_bf16']['decode_ms_per_token']:.3f} "
                  f"ms/token, graph); phase {rows['phase_s']:.1f} s")
    serve_cards_summary(smi, rows["cards"])


def serve_cards_summary(smi, c):
    """Phase R's four-card lines."""
    if not isinstance(c, dict):
        print(f"serve grid summary [4 cards, NCCL] ({smi}): {c}")
        return
    for arch in SERVE_CARDS:
        d = c["ranks"][0]["decode"][arch]
        t = d["trace"]
        print(f"serve grid summary [{arch} decode_32k B={SERVE_CARDS[arch][0]}, (data 2, model 2) "
              f"NCCL] ({smi}): ms/step={d['graph_ms_per_step']:.2f} tokens/s="
              f"{d['tokens_per_s']:.0f} peak_GB a rank="
              f"{max(r['decode'][arch]['peak_gb'] for r in c['ranks']):.2f} (reckoned "
              f"{c['reckoning'][arch]['peak']:.2f}) collective device share="
              f"{t['collective_device_ms'] / t['wall_ms']:.4f}")
    gr = c["ranks"][0]["generate"]
    print(f"serve grid summary [{SERVE_CARDS_GEN['arch']} generate, NCCL, captured] ({smi}): "
          f"decode ms/token={gr['decode_ms_per_token']:.3f} tokens/s={gr['tokens_per_s']:.1f}")


def serve_grid_only(torch, ops, smi, name, cards_only: bool = False) -> None:
    """``--phase R``: phase R alone (its four-card half where there are
    four cards), its numbers to ``chiprun_out/chip_smoke_serve_grid.json``;
    ``--phase R4`` (``cards_only``): the four-card half alone, to
    ``chip_smoke_serve_cards.json``."""
    if cards_only:
        if torch.cuda.device_count() < 4:
            fail(f"--phase R4 needs four cards, this machine has {torch.cuda.device_count()}")
        rows = {"cards": serve_cards(torch, smi)}
    else:
        rows, _ = serve_grid_phase(torch, ops, smi)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"chip_smoke_serve_{'cards' if cards_only else 'grid'}.json").write_text(
        json.dumps({"nvidia_smi": smi, "device": name, "torch": torch.__version__,
                    "serve_grid": rows}, indent=1, default=str))
    if cards_only:
        serve_cards_summary(smi, rows["cards"])
    else:
        serve_grid_summary(smi, rows)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def production_phase(torch, ops, ref, smi):
    """Phase D: smollm-135m at the reference's production input shapes.
    Returns the rows and the flash launches of its kernel-route runs (the
    twin comparisons not counted)."""
    t_phase = time.perf_counter()
    launches = {"flash_attn": 0, "flash_attn_tc": 0}
    rows = {}
    rows["prefill_32k"], params16 = prod_prefill(torch, ops, smi, launches)
    rows["long_context"] = prod_long_context(torch, ops, smi, params16, launches)
    rows["twins"] = prod_twins(torch, ops, ref, smi)
    rows["decode_32k"] = prod_decode(torch, ops, smi, "decode_32k", PROD_DECODE_B)
    rows["long_500k"] = prod_decode(torch, ops, smi, "long_500k")
    rows["long_500k_ring_window"] = prod_ring_window(torch, smi, params16)
    del params16
    torch.cuda.empty_cache()
    rows["train_4k"] = prod_train(torch, smi)
    rows["launches"] = launches
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"production phase: {rows['phase_s']:.1f} s, launches {launches}")
    return rows, launches


def production_summary(smi, rows):
    """One line a production shape of phase D, with the card's name and
    power limit, and the cuts."""
    p, lc, d, lg, t = (rows[k] for k in ("prefill_32k", "long_context", "decode_32k",
                                         "long_500k", "train_4k"))
    print(f"production summary [prefill_32k B={p['B']}] ({smi}): ms={p['ms']:.1f} peak_GB="
          f"{p['peak_gb']:.2f} analytic_TFLOP/s={p['analytic_tflops_per_s']:.1f} "
          f"model_flop_share={p['model_flop_share']:.4f}")
    print(f"production summary [f32 long context] ({smi}): kernel vs plain at "
          f"{lc['L_compared']} max diff {lc['max_abs_diff_kernel_vs_plain']:.3e}; prefill vs "
          f"forward at {lc['L_prefill']} {lc['max_abs_diff_prefill_last_vs_forward']:.3e}; "
          + "; ".join(f"{r['name']} vs twin at B={r['B']} L={r['L']} (rows "
                      f"{r['rows_compared']}) {r['max_abs_err_arith_twin']:.3e}"
                      for r in rows["twins"]))
    for r in (d, lg):
        print(f"production summary [{r['shape']} B={r['B']}] ({smi}): ms/step replayed="
              f"{r['graph_ms_per_step']:.3f} eager={r['eager_ms_per_step']:.3f} byte_share="
              f"{r['byte_share']:.4f} widening {r['widen_ms']:.3f} ms transient_GB="
              f"{r['transient_gb']:.2f}")
    tr = d.get("trace") or {}
    if tr.get("device_events"):
        print(f"production summary [decode_32k traced replay] ({smi}): wall_ms="
              f"{tr['wall_ms']:.3f} device_busy_ms={tr['device_busy_ms']:.3f} device ops="
              f"{tr['device_events']}; top: " + "; ".join(
                  f"{t['ms']:.2f} ms x{t['count']} {t['name'][:48]}" for t in tr["top"][:4]))
    print(f"production summary [train_4k] ({smi}): {t['mode']} K={t['K']} b={t['per_client_batch']}"
          f" S={t['local_steps']} ms/round={t['ms']:.1f} peak_GB={t['peak_gb']:.2f} "
          f"model_flop_share={t['model_flop_share']:.4f}")
    cuts = [f"{k}: {v['cut']}" for k, v in rows.items()
            if isinstance(v, dict) and v.get("cut")]
    print(f"production summary [cuts] ({smi}): " + "; ".join(cuts)
          + f"; phase {rows['phase_s']:.1f} s")


def train_summary(smi, rows):
    """One line a mode and dtype of phase T, with the card's name and power
    limit."""
    for r in rows["modes"]:
        first, last = r["rounds"][0], r["rounds"][-1]
        print(f"train summary [{TRAIN_ARCH} {r['dtype']} K={TRAIN_RUN['K']} {r['label']}] "
              f"({smi}): ms/round={last['ms']:.1f} (first round {first['ms']:.1f}) peak_GB="
              f"{r['peak_gb']:.3f} (start {r['start_gb']:.3f}) eval_loss={last['eval_loss']:.4f}"
              f" good_frac={last['good_frac']:.2f} afa_rounds={last['afa_rounds']}")
    print(f"train summary [launcher] ({smi}): {rows['cli']['lines'][-2]}; phase "
          f"{rows['phase_s']:.1f} s")


def scenario_summary(smi, grid, grid_wall, looped):
    """The grid's wall time, the median ms a round of the batched AFA
    gram/fused runs on each dataset, and of the looped and batched engines,
    with the card's name and power limit."""
    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    for dname in GRID_DATA:
        ms = [t for r in grid if r["dataset"] == dname and r["engine"] == "batched"
              and r["route"] == "afa gram/fused" for t in r["round_ms"]]
        print(f"grid summary [{dname}] ({smi}): afa gram/fused batched ms/round median="
              f"{median(ms):.3f}; grid wall_s={grid_wall:.1f}")
    for r in looped:
        print(f"looped summary [{r['scenario']}, {r['engine']}] ({smi}): ms/round median="
              f"{median(r['round_ms']):.3f} train_ms/round={r['train_ms']:.3f}")


def fused_summary(smi, runs, traces):
    """One line a fused route: capture time, ms a round of the replayed
    graph and of the eager body, the replayed rounds' traced busy share;
    then the batched engine's on the gram/fused route; each with the card's
    name and power limit."""
    busy = {t["label"]: t for t in traces}
    for route in FUSED_ROUTES:
        graph = next(r for r in runs if r["route"] == route and r["engine"] == "fused")
        eager = next(r for r in runs if r["route"] == route and r["engine"] == "fused_eager")
        t = busy[f"fused {route}"]
        print(f"fused summary [{route}] ({smi}): capture_s={graph['capture_s']:.3f} "
              f"ms/round replayed={graph['replay_ms_per_round']:.3f} eager="
              f"{eager['round_ms']:.3f} busy_share={t['busy_share']:.3f} "
              f"(device {t['device_busy_ms'] / t['rounds']:.3f} ms a round)")
    t = busy["batched gram/fused"]
    if "wall_ms" in t and t.get("device_busy_ms"):
        print(f"batched summary [gram/fused] ({smi}): ms/round={t['round_ms']:.3f} "
              f"busy_share={t['device_busy_ms'] / t['wall_ms']:.3f} "
              f"(device {t['device_busy_ms'] / t['rounds']:.3f} ms a round)")


def lora_summary(smi, runs, trace_row, sweeps):
    """The LoRA round replayed as a graph (ms a round without the capture,
    capture s, the traced busy share) beside the host-driven round it replaced, and
    each sweep's wall time, with the card's name and power limit."""
    for r in runs:
        print(f"lora summary [{r['route']}, {r['engine']}] ({smi}): capture_s="
              f"{r['capture_s']:.3f} ms/round without capture={r['replay_ms_per_round']:.3f}")
    t = trace_row
    print(f"lora summary [traced gram/fused graph] ({smi}): ms/round replayed="
          f"{t['replay_ms_per_round']:.3f} capture_s={t['capture_s']:.3f} busy_share="
          f"{t['busy_share']:.3f} (device {t['device_busy_ms'] / t['rounds']:.3f} ms and "
          f"{t['events_per_round']:.0f} events a round); with the clients trained one after "
          "the other on the host: 1.1-1.6 s a round, busy 0.063 (NVIDIA H100 80GB HBM3, 700 W)")
    for r in sweeps:
        print(f"sweep summary [{r['route']}] ({smi}): {len(r['seeds'])} seeds wall_s="
              f"{r['wall_s']:.3f} capture_s={r['capture_s']:.3f}")


def serve_llm_summary(smi, rows, traced):
    """One line a served configuration of phase V, the ring against the
    window, the launcher's runs and the traced token, with the card's name
    and power limit."""
    for r in rows["smollm"] + [rows["olmoe"]["bf16"]]:
        print(f"serve-LLM summary [{r['label']}] ({smi}): prefill_ms={r['prefill_ms']:.2f} "
              f"decode ms/token graph={r['decode_ms_per_token_graph']:.3f} eager="
              f"{r['decode_ms_per_token_eager']:.3f} capture_s={r['capture_s']:.3f} "
              f"tokens/s={r['tokens_per_s_graph']:.0f} kv_cache_MB={r['kv_cache_mb']:.1f}")
    r = rows["ring"]
    print(f"serve-LLM summary [ring vs window, prompt {r['prompt']}] ({smi}): ring "
          f"{r['ring_mb']:.1f} MB {r['ring_decode_ms']:.3f} ms/token, window "
          f"{r['window_mb']:.1f} MB {r['window_decode_ms']:.3f} ms/token (eager)")
    for r in rows["launcher"]:
        print(f"serve-LLM summary [launcher{' --ring' if '--ring' in r['argv'] else ''}] "
              f"({smi}): {r['lines'][-1]}")
    if traced and traced.get("device_events"):
        graph_ms = rows["smollm"][0]["decode_ms_per_token_graph"]   # bf16, kernel route
        print(f"serve-LLM summary [traced bf16 token] ({smi}): wall_ms={traced['wall_ms']:.3f} "
              f"device_busy_ms={traced['device_busy_ms']:.3f} busy_share="
              f"{traced['device_busy_ms'] / traced['wall_ms']:.3f} device ops="
              f"{traced['device_events']}; device ms / untraced graph ms a token = "
              f"{traced['device_busy_ms'] / graph_ms:.3f}; phase {rows['phase_s']:.1f} s")


def families_summary(smi, rows, traced):
    """One line a served configuration of phase Y, zamba2's ring against its
    window, hubert's forwards and the traced mamba token, with the card's
    name and power limit."""
    for r in [rows["mamba"], *rows["zamba"], rows["paligemma"]]:
        print(f"families summary [{r['label']}] ({smi}): prefill_ms={r['prefill_ms']:.2f} "
              f"decode ms/token graph={r['decode_ms_per_token_graph']:.3f} eager="
              f"{r['decode_ms_per_token_eager']:.3f} capture_s={r['capture_s']:.3f} "
              f"tokens/s={r['tokens_per_s_graph']:.0f} cache_MB={r['kv_cache_mb']:.1f}"
              + (f" SSM_state_MB={r['ssm_state_mb']:.1f}" if "ssm_state_mb" in r else ""))
    r = rows["zamba_ring"]
    print(f"families summary [zamba2-1.2b ring vs window, prompt {r['prompt']}] ({smi}): ring "
          f"{r['ring_mb']:.1f} MB {r['ring_decode_ms']:.3f} ms/token, window "
          f"{r['window_mb']:.1f} MB {r['window_decode_ms']:.3f} ms/token (eager)")
    for r in rows["hubert"]:
        print(f"families summary [hubert-xlarge {r['dtype']}/{r['route']}] ({smi}): forward "
              f"ms={r['ms']:.2f} frames/s={r['frames_per_s']:.0f}")
    if traced and traced.get("device_events"):
        graph_ms = rows["mamba"]["decode_ms_per_token_graph"]
        print(f"families summary [traced mamba2-1.3b bf16 token] ({smi}): wall_ms="
              f"{traced['wall_ms']:.3f} device_busy_ms={traced['device_busy_ms']:.3f} device "
              f"ops={traced['device_events']}; device ms / untraced graph ms a token = "
              f"{traced['device_busy_ms'] / graph_ms:.3f}; phase {rows['phase_s']:.1f} s")


def model_axis_only(torch, smi, name) -> None:
    """``--phase N``: phase N alone (its four-card half where there are four
    cards), its numbers to ``chiprun_out/chip_smoke_axis.json``."""
    rows = model_axis_phase(torch, smi)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_axis.json").write_text(json.dumps(
        {"nvidia_smi": smi, "device": name, "torch": torch.__version__, "model_axis": rows},
        indent=1))
    model_axis_summary(smi, rows)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.core import min_rounds_to_block
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    resolve_device("cuda")  # TF32 off: the reference computes in full f32
    peak_key, peaks = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks used ({peak_key}): "
          f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} FP32 TFLOP/s, "
          f"{peaks[2] / 1e12} dense bf16 TFLOP/s, {peaks[3] / 1e12} dense TF32 TFLOP/s")

    if sys.argv[1:] == ["--phase", "N"]:   # no kernel runs there
        model_axis_only(torch, smi, name)
        return
    if sys.argv[1:] in (["--phase", "E"], ["--phase", "E4"]):   # no kernel runs there
        fsdp_only(torch, smi, name, cards_only=sys.argv[2] == "E4")
        return
    t0 = time.perf_counter()
    path, log = build.build_library()
    print(f"build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] in (["--phase", "R"], ["--phase", "R4"]):   # the flash kernels run there
        serve_grid_only(torch, ops, smi, name, cards_only=sys.argv[2] == "R4")
        return
    for line in log.splitlines():
        if "Compiling entry function" in line:  # the mangled kernel name, template args
            print("  " + line.split("'")[1].split("_cu_")[-1].lstrip("0123456789")[:72])
        elif "registers" in line or "spill" in line or "warning" in line.lower():
            print("    " + line.strip())
    lib = build.load_library()

    kernel_rows, one_launch = kernel_phase(torch, ops, ref, peaks, lib)
    rank_edges = rank_edge_checks(torch, ops, ref, lib)
    gram_buckets = gram_bucket_checks(torch, ops)
    runs, launches = main_path_phase(torch, ops, min_rounds_to_block)
    baseline_runs, baseline_launches = baselines_phase(torch, ops)
    unmasked_rows, unmasked_launches = unmasked_phase(torch, ops)
    attn_rows = flash_attn_phase(torch, ops, ref, peaks)
    forward_rows, forward_launches = forward_phase(torch, ops)
    launches.update(forward_launches)
    serve_llm, serve_llm_trace, serve_llm_launches = serve_llm_phase(torch, ops)
    families, families_trace, families_launches = families_phase(torch, ops)
    train = train_phase(torch)
    production, production_launches = production_phase(torch, ops, ref, smi)
    lora_runs, lora_launches, lora_dump = lora_phase(torch, ops, min_rounds_to_block)
    fused_runs, eager_launches, fused_results = fused_phase(torch, ops, min_rounds_to_block)
    segmented = segmented_compaction_phase(torch, ops)
    fused_sync_free_round(torch)
    keyed = keyed_stream_check(torch)
    fused_traces, graph_launches = fused_trace_phase(torch, ops)
    sweeps, sweep_launches = sweep_phase(torch, ops, fused_results, min_rounds_to_block)
    lora_trace, lora_graph_launches = lora_profile_phase(torch, ops)
    serve, serve_launches = serve_phase(torch, ops, fused_results, smi, min_rounds_to_block)
    grid, noisy, grid_launches, grid_wall = paper_grid_phase(torch, ops, min_rounds_to_block)
    looped, looped_launches = looped_phase(torch, ops)
    leaf, leaf_launches = leaf_layout_phase(torch, ops, min_rounds_to_block)
    shards, shard_launches = shard_phase(torch, ops, smi, min_rounds_to_block)
    model_axis = model_axis_phase(torch, smi)
    fsdp = fsdp_phase(torch, smi)
    serve_grid, serve_grid_launches = serve_grid_phase(torch, ops, smi)
    traces = [profile_phase(torch), lora_trace, *forward_profile_phase(torch), *fused_traces]
    traces += [serve_llm_trace, families_trace]
    for more in (serve_llm_launches, families_launches, production_launches,
                 baseline_launches, unmasked_launches,
                 lora_launches, lora_graph_launches,
                 eager_launches, graph_launches, sweep_launches, serve_launches,
                 grid_launches, looped_launches, leaf_launches, shard_launches,
                 serve_grid_launches):
        for kernel, count in more.items():
            launches[kernel] += count

    kernels = []
    for row in kernel_rows:
        if row["K"] != MAIN_K or row["D"] != D_PAPER:
            continue
        replaces, source = REPLACES[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    for kname, dname, err_key in (("flash_attn", "float32", "max_abs_err"),
                                  ("flash_attn_tc", "bfloat16", "max_abs_err_arith_twin")):
        main = next(r for r in attn_rows if r["shape"] == list(ATTN_MAIN) and r["dtype"] == dname)
        replaces, source = REPLACES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": main[err_key],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "device": name, "torch": torch.__version__,
        "peaks": {"key": peak_key, "bytes_per_s": peaks[0], "fp32_flops": peaks[1],
                  "bf16_tensor_flops": peaks[2], "tf32_tensor_flops": peaks[3]},
        "kernel_checks": kernel_rows, "one_launch_checks": one_launch,
        "rank_edge_checks": rank_edges, "main_path": runs,
        "baselines": baseline_runs, "unmasked": unmasked_rows, "flash_attn_checks": attn_rows,
        "forward": forward_rows, "serve_llm": serve_llm, "families": families, "train": train,
        "production": production,
        "lora": lora_runs, "lora_round_dump": lora_dump,
        "fused": fused_runs, "sweeps": sweeps, "keyed_streams": keyed,
        "gram_buckets": gram_buckets,
        "segmented_compaction": segmented, "serve": serve, "paper_grid": grid,
        "paper_grid_noisy": noisy,
        "paper_grid_wall_s": grid_wall, "looped": looped, "leaf_layout": leaf,
        "shards": shards,
        "model_axis": model_axis,
        "fsdp": fsdp,
        "serve_grid": serve_grid,
        "launches": launches,
        "profile": traces,
    }, indent=1))
    # the summaries last, where the end of the output keeps them
    fused_summary(smi, fused_runs, fused_traces)
    lora_summary(smi, lora_runs, lora_trace, sweeps)
    scenario_summary(smi, grid, grid_wall, looped)
    serve_llm_summary(smi, serve_llm, serve_llm_trace)
    families_summary(smi, families, families_trace)
    train_summary(smi, train)
    production_summary(smi, production)
    shard_summary(smi, shards)
    model_axis_summary(smi, model_axis)
    fsdp_summary(smi, fsdp)
    serve_grid_summary(smi, serve_grid)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
