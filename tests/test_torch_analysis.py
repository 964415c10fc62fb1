"""The port's invariant linter (``repro_torch.analysis``) on the CPU, held to
the JAX package's: each rule's kernel wrapper calls against the reference's
``pallas_call`` count on the same numpy inputs and against the shared
``LAUNCH_BUDGETS``; the DNN's matrix-product FLOPs against the reference's
HLO analysis; the declared kernel geometry race-free over a K x D sweep and
both known-bad seeds flagged; host reads found where they are and nowhere
in the capturable routes and the fused round bodies; the segmented run's
programs within the pow2 bound; the sharded screening's collectives a pass
on 2 gloo ranks; the CLI; no JAX module loaded by the port's linter."""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.hlo import analyze as jax_hlo_analyze  # noqa: E402
from repro.analysis.launches import count_pallas_launches  # noqa: E402
from repro.analysis.retrace import pow2_bucket_bound as jax_pow2_bucket_bound  # noqa: E402
from repro.core import AFAConfig as JaxAFAConfig  # noqa: E402
from repro.core.baselines import RuleOptions as JaxRuleOptions  # noqa: E402
from repro.core.baselines import dispatch_rule as jax_dispatch_rule  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    CollectiveBudget,
    LaunchBudget,
    analyze_kernel_races,
    audit_programs,
    check_launch_budget,
    check_no_host_syncs,
    check_screening_budget,
    check_sources,
    count_kernel_calls,
    pow2_bucket_bound,
    record,
)
from repro_torch.analysis import costs, lint, registry  # noqa: E402
from repro_torch.analysis.races import analyze_call  # noqa: E402
from repro_torch.analysis.trace import Recording  # noqa: E402
from repro_torch.kernels import meta, ops  # noqa: E402
from repro_torch.kernels.ops import WrapperCall  # noqa: E402
from repro_torch.launch.mesh import CollectiveCall  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
# the declared geometry's sweep: K on both sides of every tile, bucket and
# path border, D from one column to the paper DNN's
SWEEP_KS = (1, 6, 10, 16, 17, 200, 1025)
SWEEP_DS = (1, 63, 10_601, 535_818)
SWEEP_ATTN = ((1, 77, 77, 4, 2, 20), (2, 100, 50, 4, 4, 128), (4, 2048, 2048, 9, 3, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------- launch budgets --------------------------------


def _jax_opts(label: str, mode: str):
    use = False if mode == "plain" else "interpret"
    if label.startswith("afa["):
        launch = label[4:-1]
        return JaxRuleOptions(use_kernels=use, afa=JaxAFAConfig(variant="gram", use_kernels=use,
                                                                kernel_launch=launch))
    return JaxRuleOptions(use_kernels=use)


CELLS = [(name, label, mode, buf) for name in sorted(registry._registered_rules())
         for mode in registry.LINT_MODES for label, _ in registry.rule_variants(name, mode)
         for buf in registry.BUFFERS]


@pytest.mark.parametrize("name,label,mode,buf", CELLS,
                         ids=[f"{c[1]}-{c[2]}-{c[3]}" for c in CELLS])
def test_wrapper_calls_match_reference_launches_and_budget(name, label, mode, buf):
    """The port's wrapper calls of one rule equal the reference's
    ``pallas_call`` count on the same numpy inputs (interpret mode or jnp)
    and the budget row (0 in the plain mode)."""
    arrays = registry._workload() if buf == "dense" else registry._adapter_workload()
    opts = dict(registry.rule_variants(name, mode))[label]
    port = count_kernel_calls(
        lambda *a: registry._Target(label, name, opts, (), mode, None).call()(*a),
        *registry._on(arrays, "cpu"))
    jopts = _jax_opts(label, mode)
    ref = count_pallas_launches(lambda u, n, p, m: jax_dispatch_rule(name, u, n, p, m, jopts),
                                *(jnp.asarray(a) for a in arrays))
    assert port == ref, (label, mode, buf, port, ref)
    budget = LaunchBudget(exact=0) if mode == "plain" else registry.LAUNCH_BUDGETS[label]
    assert budget.satisfied_by(port), (label, port, budget)


def test_rule_without_budget_row_is_an_error():
    from repro_torch.core.baselines import RULES, register_rule

    register_rule("lint_probe_rule", lambda u, n, p, m, o: None)
    try:
        report = registry.Report()
        registry.CHECKS["launch-budget"].fn(report, registry.LintScope(rules=(), modes=()))
        assert [f.target for f in report.errors] == ["lint_probe_rule"], report.findings
    finally:
        RULES.pop("lint_probe_rule")


def test_budget_violation_is_an_error_and_recording_keeps_counts():
    u = torch.randn(6, 40)
    w = torch.ones(6) / 6
    before = dict(ops.LAUNCH_COUNTS)
    findings = check_launch_budget(lambda: (ops.weighted_sum(w, u), ops.weighted_sum(w, u)),
                                   budget=LaunchBudget(exact=1), target="probe")
    assert findings and findings[0].severity == "error" and "recorded 2" in findings[0].message
    assert ops.LAUNCH_COUNTS == before            # the CPU twin route launches nothing
    with ops.recording() as calls:
        ops.coord_median(u, torch.ones(6, dtype=torch.bool))
        ops.gram(u, plan_rows=8)
    assert [(c.name, c.device.type) for c in calls] == [("coord_median_masked", "cpu"),
                                                        ("gram", "cpu")]
    assert calls[1].params == dict(K=6, D=40, ptr=u.data_ptr(), plan_rows=8)


def test_device_ops_table_is_the_declared_expansion_at_the_main_k():
    p = dict(K=10, D=535_818, ptr=256, sms=meta.H100_SMS, plan_rows=None, B=4, Lq=2048,
             Lk=2048, Hq=9, Hkv=3, causal=True)
    for name, want in meta.DEVICE_OPS_PER_CALL.items():
        assert meta.device_ops(name, p) == want, name
    assert meta.device_ops("coord_median", dict(p, K=200)) == ("rank_select_kernel",)
    assert set(meta.KERNEL_GEOMETRY) == set(meta.KERNEL_NAMES)


# ------------------------------- dot FLOPs -----------------------------------


def test_dnn_dot_flops_equal_the_reference_hlo_analysis():
    """784 x 512 x 256 x 10 at a batch of 32: the forward, and the forward
    with the backward of the loss, exactly the reference's
    ``dot_flops_scaled`` (matrix products only, no input gradient)."""
    from repro.fed.dnn import dnn_logits as jax_logits
    from repro.fed.dnn import dnn_loss as jax_loss
    from repro.fed.dnn import init_dnn as jax_init
    from repro_torch.fed import dnn

    sizes, B = (784, 512, 256, 10), 32
    jp = jax_init(jax.random.PRNGKey(0), sizes)
    x, y = jnp.zeros((B, 784)), jnp.zeros((B,), jnp.int32)
    grad = jax.jit(jax.grad(lambda p, b: jax_loss(p, b))).lower(jp, {"x": x, "y": y})
    ref_grad = jax_hlo_analyze(grad.compile().as_text())["dot_flops_scaled"]
    ref_fwd = jax_hlo_analyze(jax.jit(jax_logits).lower(jp, x).compile().as_text())[
        "dot_flops_scaled"]
    params = {k: v.requires_grad_(True) for k, v in
              dnn.init_dnn(torch.Generator(), sizes, device="cpu").items()}
    tx, ty = torch.zeros((B, 784)), torch.zeros((B,), dtype=torch.int64)
    _, rec = record(lambda: torch.autograd.grad(dnn.dnn_loss(params, {"x": tx, "y": ty}),
                                                list(params.values())))
    assert costs.analyze(rec)["dot_flops"] == ref_grad == 77_037_568
    with torch.no_grad():
        _, rec = record(dnn.dnn_logits, params, tx)
    assert costs.analyze(rec)["dot_flops"] == ref_fwd == 32 * 2 * (784 * 512 + 512 * 256 + 2560)


def test_dense_model_forward_dot_flops_within_two_percent():
    """A 2-layer dense transformer's forward (2 x 64 tokens): the port's
    blocked attention computes every tile in full as the reference's does;
    the gap is 0 at this shape, and held within 2 %."""
    from repro.models import ModelConfig as JaxModelConfig
    from repro.models import build_model as jax_build
    from repro_torch.models import ModelConfig, build_model

    cfg = dict(name="lint-dense", family="dense", num_layers=2, d_model=64, vocab_size=128,
               num_heads=4, num_kv_heads=2, d_ff=128, block_q=16, block_k=16)
    jm = jax_build(JaxModelConfig(**cfg))
    hlo = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})).lower(
        jm.init(jax.random.PRNGKey(0)), jnp.zeros((2, 64), jnp.int32)).compile().as_text()
    ref = jax_hlo_analyze(hlo)["dot_flops_scaled"]
    model = build_model(ModelConfig(**cfg))
    with torch.no_grad():
        _, rec = record(model.forward, model.init(torch.Generator(), "cpu"),
                        {"tokens": torch.zeros((2, 64), dtype=torch.int64)})
    port = costs.analyze(rec)["dot_flops"]
    assert abs(port - ref) <= 0.02 * ref, (port, ref)


# -------------------------------- grid races ---------------------------------


@pytest.mark.parametrize("K", SWEEP_KS)
def test_declared_geometry_is_race_free(K):
    for D in SWEEP_DS:
        for name in ("weighted_sum", "cosine_sim", "gram", "afa_screen", "coord_median",
                     "coord_median_masked", "trimmed_mean"):
            for ptr in (256, 4):   # aligned, and a view one float off
                call = WrapperCall(name, CPU, dict(K=K, D=D, ptr=ptr, plan_rows=None))
                assert analyze_call(call) == [], (name, K, D, ptr)


def test_declared_attention_geometry_is_race_free_and_plan_rows_too():
    for B, Lq, Lk, Hq, Hkv, D in SWEEP_ATTN:
        for name in ("flash_attn", "flash_attn_tc"):
            call = WrapperCall(name, CPU, dict(B=B, Lq=Lq, Lk=Lk, Hq=Hq, Hkv=Hkv, D=D,
                                               causal=True))
            assert analyze_call(call) == []
    for name in ("gram", "afa_screen"):   # a compacted bucket planned for the full K
        assert analyze_call(WrapperCall(name, CPU, dict(K=128, D=535_818, ptr=256,
                                                        plan_rows=200))) == []


def test_known_bad_seeds_are_errors():
    findings = registry.known_bad_findings()
    errors = [f for f in findings if f.severity == "error"]
    assert any("written by blocks" in f.message and f.target.startswith("known-bad:gram")
               for f in errors), findings
    assert any("float atomic" in f.message and "atomicAdd(out, u[i])" in f.message
               for f in errors), findings


def test_lying_declaration_is_an_error_on_every_route():
    """A Gram partial kernel declared 'per-block' whose write map shows
    split partials summed by a later launch is flagged, on a CPU call."""
    good = meta.KERNEL_GEOMETRY["gram_tf32x3_kernel"]
    kernels = dict(meta.KERNEL_GEOMETRY, gram_tf32x3_kernel=good._replace(accumulation="per-block"))
    u = torch.randn(12, 300)
    findings = analyze_kernel_races(ops.gram, u, kernels=kernels)
    assert any(f.severity == "error" and "declared 'per-block'" in f.message
               for f in findings), findings
    assert analyze_kernel_races(ops.gram, u) == []


def test_source_pass_is_clean_and_catches_an_unfenced_ticket():
    assert check_sources() == []
    path = SRC / "repro_torch" / "kernels" / "csrc" / "afa_kernels.cu"
    text = path.read_text()
    at = text.index("if (last) __threadfence();")
    broken = text[:at] + "if (last) {}" + text[at + len("if (last) __threadfence();"):]
    findings = check_sources({"afa_kernels.cu": broken})
    assert {f.message for f in findings} == {
        "LastBlock::draw() must fence (__threadfence) before and after its atomicAdd"}
    assert len(findings) == 2            # both ticket kernels: cosine and the screen
    extra = text + "\n__global__ void stray_kernel(float* x) { x[0] = 1.f; }\n"
    assert [f.severity for f in check_sources({"afa_kernels.cu": extra})] == ["warning"]


# ------------------------------ host transfers -------------------------------


def _afa(capturable, use_kernels, variant="iterative"):
    from repro_torch.core import AFAConfig
    from repro_torch.core.baselines import RuleOptions, dispatch_rule

    opts = RuleOptions(use_kernels=use_kernels, capturable=capturable,
                       afa=AFAConfig(variant=variant, use_kernels=use_kernels))
    return lambda *a: dispatch_rule("afa", *a, opts)


def test_stopping_loop_host_read_is_flagged_where_it_is():
    line = next(i for i, l in enumerate(
        (SRC / "repro_torch" / "core" / "afa.py").read_text().splitlines(), 1)
        if "changed = bool(bad.any())" in l)
    args = registry._on(registry._workload(), "cpu")
    for use_kernels in (False, "cuda"):
        findings = check_no_host_syncs(_afa(False, use_kernels), *args, target="afa")
        assert [f.message.split(" reads")[0] for f in findings] == [
            f"aten::_local_scalar_dense at core/afa.py:{line}"], findings
        assert check_no_host_syncs(_afa(True, use_kernels), *args) == []


def test_capturable_rules_and_fused_round_bodies_read_nothing_from_the_host():
    report = registry.Report()
    registry.CHECKS["host-transfer"].fn(report, registry.LintScope(
        rules=tuple(sorted(registry._registered_rules())), modes=registry.LINT_MODES))
    assert report.findings == []
    round_fn, args = registry.fused_round_body("cpu")
    _, rec = record(round_fn, *args)
    assert costs.analyze(rec)["dot_flops"] > 0             # the round really trained
    assert any(op.regions and op.regions[0].startswith("round-body#") for op in rec.ops)


# ---------------------------------- retrace ----------------------------------


def test_segmented_run_programs_stay_within_the_bound_and_repeat_builds_none():
    from repro_torch.fed.simulator import _run_segments, _segment_fn

    setup, server = registry._tiny_fused_sim("cpu", **registry.RETRACE_SIM)
    seg_fn = _segment_fn(setup, server)
    K = setup.sim.num_clients
    bound = pow2_bucket_bound(range(K - 4, K + 1), K)
    assert bound == 2 and pow2_bucket_bound(range(1, 201), 200) == 9
    drive = lambda: _run_segments(seg_fn, setup, server, [setup.sim.seed], {})  # noqa: E731
    assert audit_programs(seg_fn, drive, bound=bound, target="seg") == []
    assert sorted(seg_fn.programs) == [8, 10]          # one a bucket: 10 live, then 6
    grown: dict = {}
    findings = audit_programs(grown, lambda: grown.setdefault(len(grown), object()), bound=5)
    assert [f.message.split(" —")[0] for f in findings] == [
        "repeating an identical run built 1 more program(s)"]


@pytest.mark.parametrize("ks,cap", [(range(0, 2), 1), (range(6, 11), 10), (range(1, 201), 200),
                                    (range(17, 1026), 1025), ((3, 5, 9, 33, 64, 65), 64)])
def test_pow2_bucket_bound_equals_the_reference(ks, cap):
    assert pow2_bucket_bound(ks, cap) == jax_pow2_bucket_bound(ks, cap)


def test_retrace_check_passes():
    report = registry.run_lint(checks=("retrace",))
    assert report.ok and report.findings == [], report.findings


# -------------------------------- collectives --------------------------------


@pytest.fixture(scope="module")
def two_ranks():
    from repro_torch.launch.shards import spawn

    return spawn(registry.collective_worker, 2, backend="gloo", device="cpu", args=("cpu",))


def test_sharded_screening_keeps_the_collective_budget_on_two_ranks(two_ranks):
    findings, passes = two_ranks
    assert findings == []
    assert set(passes) == {f"afa[sharded x2]/{m}/{loop}" for m in registry.LINT_MODES
                           for loop in ("stopping", "unrolled")}
    for target, per_pass in passes.items():
        assert len(per_pass) >= 2, target       # the outliers make screening iterate
        for uses in per_pass:                   # the D-wide sum, the K gather, 3 stats
            assert [(u.kind, u.elements) for u in uses] == [
                ("psum", 128), ("gather", 8), ("psum", 3)], (target, uses)


def test_screening_budget_flags_a_second_heavy_sum_and_a_missing_pass():
    calls = [CollectiveCall("psum", ("client",), 128, 512, ("screen-pass#1",)),
             CollectiveCall("psum", ("client",), 128, 512, ("screen-pass#1",)),
             CollectiveCall("psum", ("client",), 3, 12, ("screen-pass#1",)),
             CollectiveCall("psum", ("client",), 128, 512, ("screen-pass#2",))]
    findings = check_screening_budget(calls, CollectiveBudget(scalar_elements=4))
    assert len(findings) == 1 and "pass 0: 2 heavy sums" in findings[0].message
    assert "no screening pass" in check_screening_budget(calls[:0])[0].message
    rec = costs.analyze(Recording([], [], calls))
    assert rec["collective_counts"] == {"psum": 4} and rec["collective_bytes_total"] == 1548


# ----------------------------- write-map sentinels -----------------------------


class _StoringLibrary:
    """Stand-in kernel library for the CPU: each C entry stores zeros over
    its whole output, ``extra`` bytes more (fewer where negative)."""

    def __init__(self, extra=0):
        self.extra = extra

    def repro_rank_max_k(self):
        return 1024

    def repro_weighted_sum(self, c, u, out, K, D, stream):
        ctypes.memset(out, 0, 4 * D + self.extra)
        return 0

    def repro_coord_median(self, u, mask, out, K, D, bucket, blocks, width, stream):
        ctypes.memset(out, 0, 4 * D + self.extra)
        return 0

    def repro_gram(self, u, pg, g, K, D, bt, nsplit, chunk, width, stream):
        ctypes.memset(pg, 0, 4 * nsplit * K * (K + 1) // 2)
        ctypes.memset(g, 0, 4 * K * K + self.extra)
        return 0


SENTINEL_CASES = [("weighted_sum", dict(K=5, D=63, offset=0)),
                  ("coord_median", dict(K=6, D=4099, offset=4)),
                  ("gram", dict(K=17, D=4098, offset=0))]


@pytest.mark.parametrize("extra,want", [
    (0, []), (-4, ["declared element(s) never written"]),
    (4, ["guard byte(s) past the allocation written"])])
def test_sentinel_check_holds_the_cuda_path_to_the_declared_maps(monkeypatch, extra, want):
    from repro_torch.analysis import sanitize

    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    rows = sanitize.sentinel_checks(torch, SENTINEL_CASES, device="cpu",
                                    lib=_StoringLibrary(extra))
    for name, _, findings in rows:
        assert len(findings) == len(want) and all(
            w in f for w, f in zip(want, findings)), (name, findings)
    bad = sanitize.sentinel_checks(torch, SENTINEL_CASES[2:], device="cpu",
                                   lib=_StoringLibrary(), kernels=registry.known_bad_kernels())
    assert bad[0][2] and all("outside the declared map" in f for f in bad[0][2]), bad


# ------------------------------------ CLI ------------------------------------


def test_lint_cli_passes_on_the_cpu_and_known_bad_is_detected(tmp_path):
    out = tmp_path / "lint.json"
    assert lint.main(["--json", str(out), "--markdown", str(tmp_path / "lint.md")]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["counts"]["error"] == 0
    assert report["checks_run"] == ["launch-budget", "grid-race", "host-transfer", "retrace",
                                    "collective-budget"]
    assert [f["check"] for f in report["findings"]] == ["collective-budget"]  # info: 0 ranks
    assert lint.main(["--known-bad", "--json", str(tmp_path / "bad.json")]) == 0
    bad = json.loads((tmp_path / "bad.json").read_text())
    assert bad["counts"]["error"] >= 2


def test_analysis_loads_no_jax():
    code = ("import sys; import repro_torch.analysis, repro_torch.analysis.lint, "
            "repro_torch.analysis.registry, repro_torch.kernels.meta; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_the_port_it_checks_does_not_load_the_linter():
    code = ("import sys; import repro_torch.core.afa, repro_torch.fed.engine, "
            "repro_torch.launch.mesh, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m.startswith('repro_torch.analysis')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
