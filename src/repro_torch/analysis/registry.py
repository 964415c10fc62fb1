"""Lint-check registry and the rule × kernel-mode matrix runner.

Counterpart of ``repro/analysis/registry.py``.  The linter's unit of work is
a **check**: a callable that records some entry points and returns
findings.  Checks register here by name; the CLI
(``repro_torch.analysis.lint``) runs a selected subset over every rule of
``core.baselines.RULES`` × the kernel modes × the two proposal buffers
(the dense one and LoRA's packed adapters) and aggregates one
``report.Report``.

Registering coverage for new code:

* a new **kernel** declares its geometry next to its wrapper in
  ``kernels/ops.py`` (``kernels.meta.register_kernel_geometry``); the
  grid-race check picks it up through whatever rules launch it, and the
  source pass warns about a ``__global__`` without one;
* a new **aggregation rule** gets a row in ``LAUNCH_BUDGETS`` (its kernel
  wrapper calls in the ``kernels`` mode); registering the rule in
  ``core.baselines.RULES`` without a budget row is a lint error;
* a new *kind* of invariant adds a ``@register_check`` function here.

Everything runs on the CPU (the wrappers take their twins there) unless the
scope's ``device`` is ``cuda``: then the operands live on the card, the
wrappers launch the kernels, the launch budget is also held to the device
kernels of a profiler trace, the race check rebuilds the blocks at the
card's SM count and real pointers, and the host-transfer check also runs
under ``set_sync_debug_mode("error")``.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.analysis.launches import (
    LaunchBudget,
    check_device_kernels,
    check_launch_budget,
)
from repro_torch.analysis.races import analyze_call, analyze_kernel_races, check_sources
from repro_torch.analysis.report import Finding, Report, error, info
from repro_torch.analysis.transfers import check_no_host_syncs
from repro_torch.kernels import meta

# kernel modes: "plain" runs the plain PyTorch route (use_kernels=False, no
# wrapper call), "kernels" the kernel route (the wrappers: twins on the CPU,
# kernels on the card)
LINT_MODES = ("plain", "kernels")
_USE_KERNELS = {"plain": False, "kernels": "cuda"}

# Declared kernel wrapper calls per aggregation rule in the kernels mode:
# the JAX package's pallas_call budgets (repro/analysis/registry.py), which
# the port's wrappers match one for one.  In the plain mode every rule makes
# none.  AFA is keyed per launch strategy.
LAUNCH_BUDGETS: dict[str, LaunchBudget] = {
    "fa": LaunchBudget(exact=1),
    "mkrum": LaunchBudget(exact=2),           # gram + weighted sum
    "comed": LaunchBudget(exact=1),
    "trimmed_mean": LaunchBudget(exact=1),
    "bulyan": LaunchBudget(exact=3),          # gram + wsum + masked median
    "norm_clip": LaunchBudget(exact=1),
    "geomed": LaunchBudget(exact=0),          # plain PyTorch on every route
    "centered_clip": LaunchBudget(exact=0),   # plain PyTorch on every route
    "afa[fused]": LaunchBudget(exact=1),      # afa_screen: all of Algorithm 1
    "afa[chained]": LaunchBudget(min=2),      # gram + weighted sum at least
}

BUFFERS = ("dense", "adapter")


class LintCheck(NamedTuple):
    name: str
    fn: Callable
    doc: str


CHECKS: dict[str, LintCheck] = {}


def register_check(name: str, doc: str = ""):
    def deco(fn: Callable) -> Callable:
        CHECKS[name] = LintCheck(name, fn, doc or (fn.__doc__ or ""))
        return fn

    return deco


class LintScope(NamedTuple):
    """What one lint run covers."""

    rules: tuple
    modes: tuple
    device: str = "cpu"
    ranks: int = 0
    sms: int = meta.H100_SMS


class _Target(NamedTuple):
    label: str
    rule: str
    opts: object              # core.baselines.RuleOptions
    args: tuple               # (updates, n_k, p_k, mask) on the scope's device
    mode: str
    budget: LaunchBudget | None

    def call(self, capturable: bool = False):
        from repro_torch.core.baselines import dispatch_rule

        opts = self.opts._replace(capturable=capturable)
        return lambda u, n, p, m: dispatch_rule(self.rule, u, n, p, m, opts)


def _workload(K: int = 8, d: int = 256, seed: int = 0) -> tuple:
    """The JAX package's lint workload, drawn in the same order from the same
    numpy generator: ``(updates, n_k, p_k, mask)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(K, d)).astype(np.float32)
    u[: max(K // 4, 1)] *= 25.0  # outliers: screening iterates
    n_k = rng.integers(1, 50, size=K).astype(np.float32)
    p_k = rng.uniform(0.2, 0.8, size=K).astype(np.float32)
    return u, n_k, p_k, np.ones((K,), bool)


def _adapter_workload(K: int = 8, seed: int = 0) -> tuple:
    """Packed LoRA adapter proposals, the workload-layer twin of
    ``_workload``: each row one client's adapter tree packed with its
    ``PackSpec`` (the buffer the fused engine hands ``dispatch_rule`` for
    LoRA), plus noise; numpy arrays."""
    from repro_torch.fed.workload import init_lora_adapters
    from repro_torch.utils.trees import pack_spec, pack_stack, tree_broadcast_clients

    layers = {"attn": {"wq": torch.zeros((2, 16, 16)), "wo": torch.zeros((2, 16, 16))}}
    gen = torch.Generator()
    gen.manual_seed(seed)
    adapters = init_lora_adapters(gen, layers, ("wq", "wo"), rank=2)
    rng = np.random.default_rng(seed)
    u = pack_stack(tree_broadcast_clients(adapters, K), pack_spec(adapters)).numpy()
    u = (u + rng.normal(size=u.shape)).astype(np.float32)
    u[: max(K // 4, 1)] *= 25.0
    n_k = rng.integers(1, 50, size=K).astype(np.float32)
    p_k = rng.uniform(0.2, 0.8, size=K).astype(np.float32)
    return u, n_k, p_k, np.ones((K,), bool)


def _on(arrays: tuple, device: str) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _registered_rules() -> dict:
    import repro_torch.core  # noqa: F401  (registers afa, geomed and centered_clip)
    from repro_torch.core.baselines import RULES

    return RULES


def rule_variants(name: str, mode: str) -> list:
    """``(label, RuleOptions)`` of one rule in one mode: AFA once per launch
    strategy (the gram variant, as the JAX package lints it)."""
    from repro_torch.core import AFAConfig
    from repro_torch.core.baselines import RuleOptions

    use_kernels = _USE_KERNELS[mode]
    if name != "afa":
        return [(name, RuleOptions(use_kernels=use_kernels))]
    return [(f"afa[{launch}]",
             RuleOptions(use_kernels=use_kernels,
                         afa=AFAConfig(variant="gram", use_kernels=use_kernels,
                                       kernel_launch=launch)))
            for launch in ("fused", "chained")]


def iter_targets(scope: LintScope) -> Iterator[_Target]:
    """One entry point per (rule, mode, buffer): AFA contributes a cell per
    launch strategy, and every cell runs on the dense buffer and on the
    packed adapter buffer (``adapter:{rule}/{mode}``) with the same budget."""
    rules = _registered_rules()
    inputs = {"dense": _on(_workload(), scope.device),
              "adapter": _on(_adapter_workload(), scope.device)}
    for mode in scope.modes:
        for name in scope.rules:
            if name not in rules:
                continue
            for label, opts in rule_variants(name, mode):
                budget = LaunchBudget(exact=0) if mode == "plain" else LAUNCH_BUDGETS.get(label)
                for buf in BUFFERS:
                    prefix = "" if buf == "dense" else "adapter:"
                    yield _Target(f"{prefix}{label}/{mode}", name, opts, inputs[buf], mode,
                                  budget)


@register_check("launch-budget", "kernel wrapper calls per rule × mode match the budgets")
def _check_launch_budgets(report: Report, scope: LintScope) -> None:
    for name in _registered_rules():
        keyed = {name} if name != "afa" else {"afa[fused]", "afa[chained]"}
        for k in sorted(keyed):
            if k not in LAUNCH_BUDGETS:
                report.extend([error(
                    "launch-budget", k,
                    f"rule {name!r} is registered in repro_torch.core but has no launch budget "
                    "row in repro_torch.analysis.registry.LAUNCH_BUDGETS — declare its "
                    "expected kernel wrapper calls")])
    for t in iter_targets(scope):
        if t.budget is None:
            continue
        report.extend(check_launch_budget(t.call(), *t.args, budget=t.budget, target=t.label))
        if scope.device == "cuda" and t.mode == "kernels":
            report.extend(check_device_kernels(t.call(), *t.args, target=t.label))


@register_check("grid-race", "no element written by two blocks; partials read are written")
def _check_grid_races(report: Report, scope: LintScope) -> None:
    report.extend(check_sources())
    for t in iter_targets(scope):
        if t.mode == "kernels":
            report.extend(analyze_kernel_races(t.call(), *t.args, sms=scope.sms,
                                               target=t.label))


def _tiny_fused_sim(device: str, **over):
    """A small DNN simulation on the fused engine: ``(setup, server_cfg)``."""
    from repro_torch.data import make_mnist_like
    from repro_torch.fed import ServerConfig, SimConfig
    from repro_torch.fed.simulator import _Setup

    data = make_mnist_like(n_train=300, n_test=40, dim=24)
    sim = SimConfig(**{**dict(num_clients=5, bad_frac=0.4, scenario="byzantine", rounds=2,
                              local_epochs=1, batch_size=30, hidden=(8,), engine="fused",
                              seed=0), **over})
    return _Setup(data, sim, torch.device(device)), ServerConfig(rule="afa",
                                                                 num_clients=sim.num_clients)


def _round_args(setup, state):
    from repro_torch.fed.simulator import _fused_data

    dev = setup.device
    carry = (setup.params0, state)
    return (carry, torch.zeros((), dtype=torch.int64, device=dev),
            torch.full((), setup.sim.seed, dtype=torch.int64, device=dev), _fused_data(setup))


def fused_round_body(device: str = "cpu"):
    """The DNN's fused round body (``make_fused_sim``'s ``round_fn``) and
    its arguments: the body the card captures as a CUDA graph."""
    from repro_torch.fed.engine import fused_server_state
    from repro_torch.fed.simulator import _make_setup_sim

    setup, server = _tiny_fused_sim(device)
    _, round_fn = _make_setup_sim(setup, server)
    state = fused_server_state(setup.sim.num_clients, server.alpha0, server.beta0, setup.device)
    return round_fn, _round_args(setup, state)


LINT_MODEL = dict(name="lint-lora", family="dense", num_layers=2, d_model=32, vocab_size=64,
                  num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16)


def lora_round_body(device: str = "cpu"):
    """The LoRA workload's fused round body and its arguments."""
    from repro_torch.fed.engine import EngineConfig, fused_server_state, make_fused_sim
    from repro_torch.fed.server import ServerConfig, make_rule_options
    from repro_torch.fed.workload import get_workload, make_llm_fused_data
    from repro_torch.models import ModelConfig

    cfg = ModelConfig(**LINT_MODEL)
    workload = get_workload("lora", model_cfg=cfg, rank=2)
    K = 4
    data = make_llm_fused_data(cfg, clients=K, samples_per_client=4, seq=16, n_test=4,
                               device=device)
    scfg = ServerConfig(rule="afa", num_clients=K)
    _, round_fn = make_fused_sim(
        workload, EngineConfig(scenario="byzantine", lr=0.2, momentum=0.9, dropout=False),
        rule="afa", opts=make_rule_options(scfg, K), delta_block=scfg.delta_block,
        num_clients=K, num_rounds=2, batch_s=1, batch_b=2, bad_mask=np.arange(K) < 1,
        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = workload.init_params(gen, device)
    state = fused_server_state(K, scfg.alpha0, scfg.beta0, torch.device(device))
    dev = torch.device(device)
    return round_fn, ((params, state), torch.zeros((), dtype=torch.int64, device=dev),
                      torch.zeros((), dtype=torch.int64, device=dev), data)


@register_check("host-transfer", "no host read in a capturable rule or a fused round body")
def _check_host_transfers(report: Report, scope: LintScope) -> None:
    for t in iter_targets(scope):
        report.extend(check_no_host_syncs(t.call(capturable=True), *t.args,
                                          target=f"{t.label}[capturable]"))
    round_fn, args = fused_round_body(scope.device)
    report.extend(check_no_host_syncs(round_fn, *args, target="engine.fused_round_body"))
    round_fn, args = lora_round_body(scope.device)
    report.extend(check_no_host_syncs(round_fn, *args, target="engine.lora_fused_round_body"))


RETRACE_SIM = dict(num_clients=10, bad_frac=0.4, rounds=8, segment_rounds=2)


@register_check("retrace", "programs and captures stay within the O(log K) bucket bound")
def _check_retrace(report: Report, scope: LintScope) -> None:
    """A segmented fused run whose byzantine clients are blocked (10 live
    clients, then 6: buckets 10 and 8) builds at most one program per
    bucket and its repeat none; one ``DecodeProgram`` serves repeated
    ``generate`` calls with one key; the cached host factories miss once."""
    from repro_torch.analysis.retrace import audit_host_cache, audit_programs, pow2_bucket_bound
    from repro_torch.fed.simulator import _run_segments, _segment_fn

    cuda = scope.device == "cuda"
    setup, server = _tiny_fused_sim(scope.device, **RETRACE_SIM)
    K = setup.sim.num_clients
    n_bad = int(setup.bad_mask.sum())
    seg_fn = _segment_fn(setup, server)
    bound = pow2_bucket_bound(range(K - n_bad, K + 1), K)
    target = f"engine.segmented K={K} ({n_bad} byzantine)"
    report.extend(audit_programs(
        seg_fn, lambda: _run_segments(seg_fn, setup, server, [setup.sim.seed], {}),
        bound=bound, target=target, captured=cuda))
    if len(seg_fn.programs) < 2:
        report.extend([error("retrace", target,
                             f"the run built {len(seg_fn.programs)} program(s): it never "
                             "compacted, so the audit would hold vacuously")])

    from repro_torch.launch.serve import generate
    from repro_torch.models import ModelConfig, build_model

    model = build_model(ModelConfig(**LINT_MODEL))
    gen = torch.Generator(device=scope.device)
    gen.manual_seed(0)
    params = model.init(gen, scope.device)
    prompts = torch.arange(2 * 8, device=scope.device).reshape(2, 8) % LINT_MODEL["vocab_size"]
    programs: dict = {}
    report.extend(audit_programs(
        programs, lambda: generate(model, params, prompts, gen=4, ring=False, cache_size=12,
                                   programs=programs),
        bound=1, target="serve.generate decode program", captured=cuda))

    from repro_torch.fed import workload as wl
    from repro_torch.fed.engine import EngineConfig, make_packed_propose_fn
    from repro_torch.fed.server import make_rule_options
    from repro_torch.serve import service

    lora = wl.get_workload("lora", model_cfg=ModelConfig(**LINT_MODEL), rank=2)
    report.extend(audit_host_cache(
        wl._lora_model, lambda: [lora.init_params(None, "meta") for _ in range(2)], bound=1,
        target="fed.workload._lora_model rebuild"))
    report.extend(audit_host_cache(
        wl._lora_loss_fn, lambda: [wl._lora_loss_fn(lora.model_cfg, lora.targets, lora.scaling)
                                   for _ in range(2)],
        bound=1, target="fed.workload._lora_loss_fn rebuild"))
    cfg = EngineConfig(scenario="byzantine", lr=0.2, momentum=0.9, dropout=False)
    report.extend(audit_host_cache(
        make_packed_propose_fn, lambda: [make_packed_propose_fn(lora, cfg, 4, 1, 2)
                                         for _ in range(2)],
        bound=1, target="fed.engine.make_packed_propose_fn rebuild"))
    opts = make_rule_options(server, K)
    report.extend(audit_host_cache(
        service._make_agg_step, lambda: [service._make_agg_step(lora, "afa", opts, 0.95, 0.7)
                                         for _ in range(2)],
        bound=1, target="serve.service._make_agg_step rebuild"))


def collective_worker(device: str, K: int = 8, d: int = 128) -> tuple:
    """One rank of the collective audit: the client-sharded AFA on this
    rank's rows of the lint workload, on the plain and the kernel route, with
    the stopping loop and unrolled.  Returns ``(findings, passes)``, the same
    on every rank: ``passes`` maps each run to its collectives a screening
    pass (``collectives.pass_collectives``)."""
    import torch.distributed as dist

    from repro_torch.analysis.collectives import (
        CollectiveBudget,
        check_screening_budget,
        pass_collectives,
    )
    from repro_torch.core import AFAConfig, afa_aggregate
    from repro_torch.launch.mesh import make_client_mesh, recording

    shards = dist.get_world_size()
    mesh = make_client_mesh(shards, device)
    u, n_k, p_k, mask = _on(_workload(K=K, d=d), str(mesh.device))
    rows = mesh.row_block(K // shards)
    # scalar_elements=4 sits above the 3-scalar statistics and below anything
    # that scales with K or d, so the K = 8 gather counts as heavy
    budget = CollectiveBudget(max_heavy_sum=1, max_heavy_gather=1, scalar_elements=4)
    findings, passes = [], {}
    for mode in LINT_MODES:
        cfg = AFAConfig(variant="iterative", client_mesh=mesh, use_kernels=_USE_KERNELS[mode])
        for unroll in (False, True):
            target = f"afa[sharded x{shards}]/{mode}/{'unrolled' if unroll else 'stopping'}"
            with recording() as calls:
                afa_aggregate(u[rows].contiguous(), n_k[rows], p_k[rows], mask0=mask[rows],
                              config=cfg, unroll=unroll)
            findings += check_screening_budget(calls, budget, target=target)
            passes[target] = pass_collectives(calls)
    return findings, passes


@register_check("collective-budget",
                "sharded AFA: <= 1 heavy sum + 1 heavy gather per screening pass")
def _check_collective_budget(report: Report, scope: LintScope) -> None:
    if scope.ranks < 2:
        report.extend([info("collective-budget", "afa[sharded]",
                            f"{scope.ranks} rank(s): the client mesh needs >= 2 (rerun with "
                            "--ranks N)")])
        return
    from repro_torch.launch.shards import spawn

    findings, _ = spawn(collective_worker, scope.ranks, backend="gloo", device=scope.device,
                        args=(scope.device,))
    report.extend(findings)


def known_bad_kernels() -> dict:
    """The declared geometry with the seeded known-bad Gram declaration: a
    write map that drops the split index (every split of a tile pair stores
    its partial into split 0's slot)."""
    from repro_torch.kernels import ops

    good = meta.KERNEL_GEOMETRY["gram_tf32x3_kernel"]

    def dropped_split(p, grid):
        w = good.writes(p, grid)
        nsplit = ops.gram_geometry(p["K"], p["D"], p["ptr"], p["sms"]).nsplit
        iv = w["pg"]
        slot = iv.starts // nsplit * nsplit
        w["pg"] = meta.Intervals(slot, slot + 1, iv.blocks)
        return w

    return dict(meta.KERNEL_GEOMETRY, gram_tf32x3_kernel=good._replace(writes=dropped_split))


def known_bad_findings() -> list[Finding]:
    """The seeded known-bad geometry and source, which the race check MUST
    flag: ``known_bad_kernels``' Gram declaration, and a kernel source with a
    float ``atomicAdd``."""
    from repro_torch.kernels.ops import WrapperCall

    findings = analyze_call(WrapperCall("gram", torch.device("cpu"),
                                        dict(K=8, D=256 * 64, ptr=256, plan_rows=None)),
                            kernels=known_bad_kernels(), target="known-bad:gram[split index dropped]")
    findings += check_sources({"known-bad:seeded_sum.cu": SEEDED_FLOAT_ATOMIC})
    return findings


SEEDED_FLOAT_ATOMIC = """
__global__ void seeded_sum_kernel(const float* __restrict__ u, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(out, u[i]);
}
"""


def run_lint(checks: tuple | None = None, rules: tuple | None = None,
             modes: tuple | None = None, *, device: str = "cpu", ranks: int = 0) -> Report:
    """Run the selected checks over the rule × mode matrix.  The race check
    takes the card's SM count on ``cuda``, H100's 132 on the CPU."""
    all_rules = tuple(sorted(_registered_rules()))
    sms = meta.H100_SMS
    if device == "cuda":
        from repro_torch import resolve_device

        resolve_device("cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    scope = LintScope(rules=tuple(rules) if rules else all_rules,
                      modes=tuple(modes) if modes else LINT_MODES, device=device,
                      ranks=int(ranks), sms=sms)
    unknown = set(scope.modes) - set(LINT_MODES)
    if unknown:
        raise ValueError(f"unknown lint mode(s) {sorted(unknown)}; expected a subset of "
                         f"{LINT_MODES}")
    report = Report(meta={"rules": list(scope.rules), "modes": list(scope.modes),
                          "device": device, "ranks": scope.ranks, "sms": scope.sms,
                          "torch": torch.__version__})
    for name in checks if checks else tuple(CHECKS):
        if name not in CHECKS:
            raise ValueError(f"unknown check {name!r}; registered: {sorted(CHECKS)}")
        CHECKS[name].fn(report, scope)
        report.mark_ran(name)
    return report
