"""Batched serving driver: prefill + decode loop over a request queue.

Counterpart of ``repro/launch/serve.py``: the same arguments, prompts and
printed lines, for every decoder family (dense, MoE, SSM, hybrid, VLM;
an encoder is refused), with the linear cache or (``--ring``) the
sliding-window ring cache of the attention layers.  A VLM's patch
embeddings are drawn as the reference draws them, after each batch's
prompts from the same generator; its linear cache holds the patches too
(``prefix_len + prompt_len + gen`` slots), where the reference sizes it
``prompt_len + gen`` and XLA drops the decode steps' writes past its end
(ROADMAP C.11).  ``generate`` serves one batch: an eager prefill (its
length varies by request), then one decode step a token.  On the card the
step (``decode_step`` and the argmax) is captured once as a CUDA graph over
static token, position and cache buffers, per (batch, cache size, ring),
and replayed for every token: the counterpart of the reference's
``jax.jit(decode)``.  On the CPU, or with ``graph=False``,
the same step runs eagerly.

A model built on a grid (``build_model(cfg, grid=)``, dense or MoE) serves
on it: every rank is given the whole batch of prompts, its prefill keeps
the rank's rows over the data axes and its block of the cache, and the
program's buffers hold that block and those rows; ``Generation.tokens``
and ``.logits`` are this rank's rows.  Under NCCL the step is captured
with its collectives as one CUDA graph; gloo's collectives cannot be
captured, so under gloo (chosen by the group's backend) every step runs
eagerly.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 8 --batch 4 --prompt-len 2048 --gen 64 [--ring]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
      --device cpu --requests 2 --batch 2 --prompt-len 16 --gen 4 [--ring]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --reduced \\
      --device cpu --requests 2 --batch 2 --prompt-len 16 --gen 4
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.model import tree_apply


class Generation(NamedTuple):
    tokens: torch.Tensor   # (B, gen) int64: the prefill's token, then one a decode step
    logits: torch.Tensor   # (B, V) f32, the last step's
    cache: dict            # the cache after the last step (the program's buffers)
    times: dict            # prefill_s, capture_s, decode_s, decode_steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits: torch.Tensor, temperature: float, generator=None) -> torch.Tensor:
    """Greedy (argmax) at ``temperature <= 0``, else a draw from
    ``softmax(logits / temperature)`` by the Gumbel-max trick on uniforms
    from ``generator``, as ``jax.random.categorical`` draws (not its
    stream).  Reads nothing from the host."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1)


class DecodeProgram:
    """One decode step over static buffers, for one (batch, cache size,
    ring) and one set of parameters.

    The given cache (any family's tree) is the program's cache buffer, used
    in place; the program adds the next token's and the step's logits'
    buffers.  ``load()`` copies a prefill's cache and first token into them.
    ``step()`` runs ``decode_step`` on them (the cache and its ``pos``
    written in place), copies the logits out and, when greedy, writes the
    argmax into the token buffer.  ``capture()`` records ``step()`` as a
    CUDA graph: one warm-up step on a side stream, then the capture.  The
    warm-up step writes into the cache buffer and advances its ``pos``, so a
    caller loads the buffers after ``capture()``, or fills them again.
    ``run()`` replays the graph, or on the CPU calls ``step()``.

    On a grid model the buffers are this rank's block of the cache and its
    rows, and ``cache_size`` the whole cache's slots.  ``capture()`` records
    the step's collectives with it under NCCL and raises under gloo, whose
    collectives cannot be captured (``run()`` then calls ``step()``).  The
    grid's Python-side counters (``GridMesh.all_reduces``, ...) count the
    collectives once, at capture; a replay does not count them again."""

    def __init__(self, model, params, cache: dict, *, ring: bool, greedy: bool,
                 cache_size: int | None = None):
        self.model, self.params, self.ring, self.greedy = model, params, ring, greedy
        self.cache, self.cache_size = cache, cache_size
        b, dev = cache["pos"].shape[0], cache["pos"].device
        self.tok = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.logits = torch.zeros((b, model.config.vocab_size), dtype=torch.float32,
                                  device=dev)
        self.graph = None
        self.capture_s = 0.0

    def step(self) -> None:
        logits, _ = self.model.decode_step(self.params, self.cache, self.tok, ring=self.ring,
                                           cache_size=self.cache_size)
        self.logits.copy_(logits)
        if self.greedy:
            self.tok.copy_(torch.argmax(logits, dim=-1))

    def load(self, cache: dict, tok: torch.Tensor) -> None:
        tree_apply(lambda dst, src: dst.copy_(src), self.cache, cache)
        self.tok.copy_(tok)

    def capture(self) -> None:
        grid = self.model.grid
        if grid is not None and getattr(grid, "backend", None) != "nccl":
            raise ValueError(f"a decode step on a {getattr(grid, 'backend', None)} grid cannot "
                             "be captured: its "
                             "collectives run on the host; run() steps it eagerly")
        dev = self.tok.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # on a grid the NCCL watchdog thread keeps querying its events while
        # this thread captures: the capture restricts this thread alone
        mode = "global" if grid is None else "thread_local"
        with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
            self.step()
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.step()


@torch.no_grad()
def generate(model, params, prompts: torch.Tensor, *, gen: int, ring: bool, cache_size: int,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             graph: bool = True, programs: dict | None = None,
             patch_embeds: torch.Tensor | None = None) -> Generation:
    """Serve one batch of prompts (B, P) int on their device: prefill, then
    ``gen - 1`` decode steps, ``gen`` tokens in all.  A VLM takes its
    ``patch_embeds`` (B, prefix_len, frontend_dim), prefilled before the
    prompts.

    ``ring`` takes the sliding window and the ring cache of ``cache_size``
    slots; else the cache is linear and must hold the prefix, ``P`` and
    ``gen - 1`` positions.
    ``temperature > 0`` samples with ``generator`` (on the prompts' device),
    else decoding is greedy.  On the card with ``graph=True`` each step is a
    replay of one captured ``DecodeProgram`` (on a grid model, under NCCL
    only: a gloo grid steps eagerly); ``programs`` (a dict the
    caller keeps) holds the programs by (batch, cache size, ring, greedy) so
    that later batches of the same shape replay the same capture.  The
    returned cache is the program's buffers: a later call with the same
    ``programs`` overwrites it."""
    dev = prompts.device
    b, plen = prompts.shape
    batch = {"tokens": prompts}
    if (patch_embeds is not None) != (model.config.family == "vlm"):
        raise ValueError(f"{model.config.name}: patch_embeds are given with a VLM, and only "
                         "with one")
    prefix = 0
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
        prefix = patch_embeds.shape[1]
    if not ring and cache_size < prefix + plen + gen - 1:
        raise ValueError(f"a linear cache of {cache_size} slots cannot hold {prefix} prefix, "
                         f"{plen} prompt and {gen - 1} decoded positions")
    greedy = temperature <= 0
    times = {"prefill_s": 0.0, "capture_s": 0.0, "decode_s": 0.0, "decode_steps": gen - 1}
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache_size=cache_size, use_window=ring)
    tok = sample(logits, temperature, generator)
    _sync(dev)
    times["prefill_s"] = time.perf_counter() - t0
    out = [tok]
    if gen > 1:
        programs = {} if programs is None else programs
        key = (b, cache_size, ring, greedy)
        prog = programs.get(key)
        if prog is None or prog.params is not params or prog.model is not model:
            prog = programs[key] = DecodeProgram(model, params,
                                                 tree_apply(torch.zeros_like, cache),
                                                 ring=ring, greedy=greedy, cache_size=cache_size)
            if graph and dev.type == "cuda" and (
                    model.grid is None or getattr(model.grid, "backend", None) == "nccl"):
                prog.capture()
                times["capture_s"] = prog.capture_s
        prog.load(cache, tok)
        del cache
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            prog.run()
            if not greedy:
                prog.tok.copy_(sample(prog.logits, temperature, generator))
            out.append(prog.tok.clone())
        _sync(dev)
        times["decode_s"] = time.perf_counter() - t0
        logits, cache = prog.logits, prog.cache
    return Generation(torch.stack(out, dim=1), logits, cache, times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--ring", action="store_true", help="sliding-window ring cache")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().with_(param_dtype="float32", compute_dtype="float32")
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    if args.ring and not cfg.sliding_window:
        raise SystemExit(f"{cfg.name} has no sliding window configured")
    model = build_model(cfg)
    init_gen = torch.Generator(device=device)
    init_gen.manual_seed(0)
    params = model.init(init_gen, device)
    rng = np.random.default_rng(0)  # the reference's prompts
    sampler = torch.Generator(device=device)
    sampler.manual_seed(0)
    prefix = cfg.prefix_len if cfg.family == "vlm" else 0
    cache_size = cfg.sliding_window if args.ring else prefix + args.prompt_len + args.gen
    programs: dict = {}

    n_batches = (args.requests + args.batch - 1) // args.batch
    total_tokens = 0
    t_start = time.perf_counter()
    for bi in range(n_batches):
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
        patches = None
        if prefix:
            patches = torch.from_numpy(rng.normal(
                size=(args.batch, prefix, cfg.frontend_dim)).astype(np.float32)).to(device)
        res = generate(model, params, prompts, gen=args.gen, ring=args.ring,
                       cache_size=cache_size, temperature=args.temperature,
                       generator=sampler, programs=programs, patch_embeds=patches)
        t = res.times
        total_tokens += args.batch * args.gen
        print(
            f"batch {bi}: prefill {args.batch}x{args.prompt_len} in {t['prefill_s']*1e3:.0f}ms, "
            f"decoded {args.gen} tok in {t['decode_s']*1e3:.0f}ms "
            f"({t['decode_s']/max(args.gen-1,1)*1e3:.1f} ms/tok)",
            flush=True,
        )
    dt = time.perf_counter() - t_start
    print(f"served {args.requests} requests, {total_tokens} tokens, "
          f"{total_tokens/dt:.1f} tok/s ({'ring' if args.ring else 'linear'} cache)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
