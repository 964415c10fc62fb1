"""ClientWorkload — the pluggable client-training layer.

Counterpart of ``repro/fed/workload.py``.  A workload builds the model
(``init_params``), runs local training for all K clients of a round
(``local_update``, returning a stacked proposal tree), maps params to
proposal space and back (``codec``) and scores the model (``eval_metric``).
``DnnWorkload`` is the paper's DNN; ``TransformerLoraWorkload`` fine-tunes a
frozen transformer base through LoRA adapters, so the packed aggregation
buffer is ``(K, D_adapter)`` with ``D_adapter`` far below the model size.
``simulate_llm`` runs the LoRA workload on the fused engine (one CUDA graph a
round on the card), ``run_llm_simulation`` is its deprecated shim.
``validate_submission`` is the serving tier's check of one submitted row.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.attacks import stream_seed
from repro_torch.fed.client import local_sgd, local_sgd_frozen_clients
from repro_torch.fed.dnn import dnn_error, dnn_loss, init_dnn
from repro_torch.utils.philox import keyed_bits
from repro_torch.utils.trees import (
    PackSpec,
    pack_spec,
    tree_broadcast_clients,
    tree_size,
)


class ProposalCodec(NamedTuple):
    """params <-> proposal-space map."""

    proposal_of: Callable[[Any], Any]
    apply: Callable[[Any, Any], Any]


def _identity_proposal(params):
    return params


def _identity_apply(params, aggregate):
    del params
    return aggregate


#: full-parameter proposals: the aggregate IS the next global model
IDENTITY_CODEC = ProposalCodec(_identity_proposal, _identity_apply)


def _adapter_proposal(params):
    return params["adapters"]


def _adapter_apply(params, aggregate):
    return {"base": params["base"], "adapters": aggregate}


#: low-rank-delta proposals: clients send only the adapter tree; the server
#: swaps the aggregated adapters in against the frozen base
ADAPTER_CODEC = ProposalCodec(_adapter_proposal, _adapter_apply)


_NUMPY_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
                 torch.float16: np.float16}


def validate_submission(spec: PackSpec, payload) -> np.ndarray:
    """Validate ONE submitted packed proposal row against a workload's
    ``PackSpec``: the serving tier's wire contract.

    A submission is a ``(D,)`` row of the packed aggregation buffer (a numpy
    array or a tensor, on any device), whose dtype casts ``same_kind`` to the
    spec's and whose entries are finite.  Anything else raises
    ``ValueError``, and the service rejects the submission at ingress.  The
    finiteness check matters: a masked-out row is zeroed by multiplication in
    the aggregation, and ``0 * inf`` is nan.  Returns the row as a host array
    in the spec's dtype."""
    want = _NUMPY_DTYPES.get(spec.dtype)
    if want is None:
        raise ValueError(f"packed buffer dtype {spec.dtype} has no numpy counterpart")
    if isinstance(payload, torch.Tensor):
        payload = payload.detach().cpu().resolve_conj().numpy()
    row = np.asarray(payload)
    if row.shape != (spec.dim,):
        raise ValueError(f"submission shape {row.shape} != ({spec.dim},): one packed "
                         "proposal row per submission")
    if not np.can_cast(row.dtype, want, casting="same_kind"):
        raise ValueError(f"submission dtype {row.dtype} does not cast to the packed "
                         f"buffer dtype {np.dtype(want)}")
    row = row.astype(want, copy=False)
    if not np.all(np.isfinite(row)):
        raise ValueError("submission contains non-finite entries")
    return row


class ClientWorkload:
    """Protocol base (subclasses are frozen dataclasses)."""

    name: str = "abstract"
    codec: ProposalCodec = IDENTITY_CODEC

    def init_params(self, generator: torch.Generator, device):
        raise NotImplementedError

    def local_update(self, cfg, params, batches, client_seeds, train_mask=None):
        """Local training of K clients from the global ``params`` ->
        stacked proposal tree.  ``batches`` leaves are ``(K, S, b, ...)``;
        ``client_seeds`` holds one torch-generator seed per row.  Rows where
        the (K,) ``train_mask`` is False may be left untrained: the caller
        resets them to ``w_t``."""
        raise NotImplementedError

    def local_update_keyed(self, cfg, params, batches, seed, offsets):
        """``local_update`` for the fused engines: row r's randomness comes
        from the keyed stream ``(seed, stream, offsets[r])``
        (``utils/philox.py``; ``offsets`` = round * K + original client id,
        ``seed`` a 0-d device tensor), so the call reads nothing from the host
        and a client's draws do not depend on its row."""
        raise NotImplementedError(
            f"workload {self.name!r} has no keyed local update, which the fused "
            "engines need"
        )

    def eval_metric(self, params, x_test, y_test):
        """Scalar error in [0, 1] on the held-out set."""
        raise NotImplementedError

    def delta_spec(self, params) -> PackSpec:
        """PackSpec of one proposal row — the ``(K, D)`` buffer layout."""
        return pack_spec(self.codec.proposal_of(params))

    def proposal_dim(self, params) -> int:
        """D: flattened size of one proposal row."""
        return tree_size(self.codec.proposal_of(params))

    def validate_submission(self, params, payload) -> np.ndarray:
        """Ingress validation of one submitted packed proposal row (see
        :func:`validate_submission`)."""
        return validate_submission(self.delta_spec(params), payload)

    def param_dim(self, params) -> int:
        """Total model size (frozen + trainable)."""
        return tree_size(params)


# stream tag of the dropout masks
_DROPOUT_STREAM = 0xD0
DROPOUT_P = 0.5


@dataclasses.dataclass(frozen=True)
class DnnWorkload(ClientWorkload):
    """The paper's MNIST/Spambase DNN as a workload."""

    sizes: tuple  # (d_in, *hidden, d_out)

    name = "dnn"
    codec = IDENTITY_CODEC

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))

    def init_params(self, generator: torch.Generator, device):
        return init_dnn(generator, self.sizes, device=device)

    def dropout_keep(self, client_seeds, steps: int, batch: int, device):
        """Per-hidden-layer keep masks ``(K, S, b, width)``: client k's masks
        for the round come from one generator seeded by ``client_seeds[k]``."""
        widths = self.sizes[1:-1]
        rows = []
        for s in client_seeds:
            gen = torch.Generator(device=device)
            gen.manual_seed(stream_seed(_DROPOUT_STREAM, s))
            u = torch.rand((steps, batch, sum(widths)), generator=gen, device=device)
            rows.append(u >= DROPOUT_P)
        keep = torch.stack(rows)
        return list(torch.split(keep, list(widths), dim=-1))

    def dropout_keep_keyed(self, seed, offsets, steps: int, batch: int):
        """``dropout_keep`` from the keyed stream: row r's masks are the
        first ``steps * batch * sum(widths)`` fair bits of the stream ``(seed,
        dropout stream, offsets[r])``, one bit a unit (DROPOUT_P = 0.5)."""
        widths = self.sizes[1:-1]
        keep = keyed_bits(seed, _DROPOUT_STREAM, offsets, steps * batch * sum(widths))
        keep = keep.reshape(offsets.shape[0], steps, batch, sum(widths))
        return list(torch.split(keep, list(widths), dim=-1))

    def _train(self, cfg, params, batches, keep):
        # every row trains: one batched pass costs no more than a masked one
        K = batches["x"].shape[0]
        return local_sgd(
            dnn_loss, tree_broadcast_clients(params, K), batches,
            lr=cfg.lr, momentum=cfg.momentum, dropout_keep=keep,
        )

    def local_update(self, cfg, params, batches, client_seeds, train_mask=None):
        x = batches["x"]
        keep = (self.dropout_keep(client_seeds, x.shape[1], x.shape[2], x.device)
                if cfg.dropout else None)
        return self._train(cfg, params, batches, keep)

    def local_update_keyed(self, cfg, params, batches, seed, offsets):
        x = batches["x"]
        keep = (self.dropout_keep_keyed(seed, offsets, x.shape[1], x.shape[2])
                if cfg.dropout else None)
        return self._train(cfg, params, batches, keep)

    def eval_metric(self, params, x_test, y_test):
        return dnn_error(params, x_test, y_test)


# ---------------------------------------------------------------------------
# TransformerLoraWorkload — federated LLM fine-tuning on low-rank deltas
# ---------------------------------------------------------------------------
#
# Clients hold a frozen transformer base (repro_torch.models, stacked layer
# leaves with a leading L axis) and train only LoRA adapters on the stacked
# attention projections: for each target matrix W (L, d_in, d_out) an A
# (L, d_in, r) / B (L, r, d_out) pair with B zero-initialised, merged as
# W + (alpha/r) * A @ B per layer.  The proposal space is the adapter tree.


@functools.lru_cache(maxsize=8)
def _lora_model(model_cfg):
    from repro_torch.models import build_model

    return build_model(model_cfg)


def _adapter_sites(layers, targets):
    """(path, leaf) of every stacked ``(L, d_in, d_out)`` leaf whose final
    key names a LoRA target, in dict order (as the JAX package walks it)."""
    sites = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif path and path[-1] in targets and node.ndim == 3:
            sites.append((path, node))

    walk(layers, ())
    return sites


def init_lora_adapters(generator: torch.Generator | None, layers, targets, rank: int):
    """Adapter tree mirroring ``layers``: at each target leaf a ``{"a": (L,
    d_in, r), "b": (L, r, d_out)}`` pair in f32, A ~ N(0, 1/d_in), B = 0, so
    the initial delta is exactly zero.  A is drawn from ``generator`` on the
    layers' device (nothing is drawn on ``meta``)."""
    sites = _adapter_sites(layers, targets)
    if not sites:
        raise ValueError(f"no LoRA target leaves {targets!r} found in the layer stack")
    adapters: dict = {}
    for path, leaf in sites:
        L, d_in, d_out = leaf.shape
        a = torch.empty((L, d_in, rank), dtype=torch.float32, device=leaf.device)
        if leaf.device.type != "meta":
            a.normal_(generator=generator)
        node = adapters
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {
            "a": a / math.sqrt(d_in),
            "b": torch.zeros((L, rank, d_out), dtype=torch.float32, device=leaf.device),
        }
    return adapters


def merge_lora(layers, adapters, scaling: float):
    """Effective layer stack: target leaves get ``W + scaling * A @ B``
    (batched over the layer axis, in f32, cast back to W's dtype), everything
    else passes through."""

    def walk(node, anode):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            sub = anode.get(k) if isinstance(anode, dict) else None
            if isinstance(sub, dict) and set(sub) == {"a", "b"} and not isinstance(v, dict):
                delta = torch.einsum("lir,lro->lio", sub["a"], sub["b"]) * scaling
                out[k] = (v.float() + delta).to(v.dtype)
            else:
                out[k] = walk(v, sub)
        return out

    return walk(layers, adapters)


def _merged_params(base, adapters, scaling: float):
    eff = dict(base)
    eff["layers"] = merge_lora(base["layers"], adapters, scaling)
    return eff


@functools.lru_cache(maxsize=8)
def _lora_loss_fn(model_cfg, targets, scaling: float):
    """Loss over (frozen base, adapters) with the engine's ``{"x","y"}``
    batch convention mapped to the LM's ``{"tokens","labels"}``."""
    model = _lora_model(model_cfg)

    def loss(base, adapters, mb):
        eff = _merged_params(base, adapters, scaling)
        return model.loss_fn(eff, {"tokens": mb["x"], "labels": mb["y"]})[0]

    return loss


@dataclasses.dataclass(frozen=True)
class TransformerLoraWorkload(ClientWorkload):
    """Federated LLM fine-tuning: clients propose LoRA deltas on a frozen
    transformer base (see the section comment above)."""

    model_cfg: Any  # repro_torch.models.ModelConfig (frozen dataclass, hashable)
    rank: int = 4
    alpha: float = 8.0
    targets: tuple = ("wq", "wk", "wv", "wo")

    name = "lora"
    codec = ADAPTER_CODEC

    def __post_init__(self):
        object.__setattr__(self, "targets", tuple(self.targets))

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.rank)

    def init_params(self, generator: torch.Generator | None, device="cuda"):
        base = _lora_model(self.model_cfg).init(generator, device)
        adapters = init_lora_adapters(generator, base["layers"], self.targets, self.rank)
        return {"base": base, "adapters": adapters}

    def _train(self, cfg, params, batches):
        # every row trains in one pass over the client axis (the engine
        # resets non-trainers to w_t): a masked pass would cost the same
        K = batches["x"].shape[0]
        return local_sgd_frozen_clients(
            _lora_loss_fn(self.model_cfg, self.targets, self.scaling), params["base"],
            tree_broadcast_clients(params["adapters"], K), batches,
            lr=cfg.lr, momentum=cfg.momentum,
        )

    def local_update(self, cfg, params, batches, client_seeds, train_mask=None):
        """SGD with momentum on the adapters of all K rows at once, the base
        frozen and shared (``local_sgd_frozen_clients``).  The LM stack is
        deterministic, so the seeds are not used."""
        del client_seeds, train_mask
        return self._train(cfg, params, batches)

    def local_update_keyed(self, cfg, params, batches, seed, offsets):
        """``local_update`` for the fused engines: the LM stack draws
        nothing, so neither ``seed`` nor ``offsets`` is used, as the JAX
        package's LoRA loss ignores its dropout key."""
        del seed, offsets
        return self._train(cfg, params, batches)

    @torch.no_grad()
    def eval_metric(self, params, x_test, y_test):
        """Masked next-token error: fraction of (label >= 0) positions where
        the greedy prediction misses."""
        model = _lora_model(self.model_cfg)
        logits = model.forward(self.merged_params(params), {"tokens": x_test})
        pred = torch.argmax(logits, dim=-1)
        mask = y_test >= 0
        wrong = torch.sum(((pred != y_test) & mask).float())
        return wrong / torch.clamp(torch.sum(mask.float()), min=1.0)

    def merged_params(self, params):
        """Full effective model (base + scaled deltas) — inference/export."""
        return _merged_params(params["base"], params["adapters"], self.scaling)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _build_dnn(*, sizes, **_ignored) -> DnnWorkload:
    return DnnWorkload(sizes=tuple(sizes))


def _build_lora(
    *, arch: str = "smollm-135m", reduced: bool = True, rank: int = 4,
    alpha: float = 8.0, model_cfg=None, clients: int | None = None, **_ignored,
) -> TransformerLoraWorkload:
    if model_cfg is None:
        from repro_torch.configs import get_config

        model_cfg = get_config(arch)
        if reduced:
            model_cfg = model_cfg.reduced().with_(
                param_dtype="float32", compute_dtype="float32"
            )
    if clients is not None:
        model_cfg = model_cfg.with_(fed_clients=int(clients))
    return TransformerLoraWorkload(model_cfg=model_cfg, rank=rank, alpha=alpha)


WORKLOADS: dict[str, Callable[..., ClientWorkload]] = {
    "dnn": _build_dnn,
    "lora": _build_lora,
}


def get_workload(name: str, **kwargs) -> ClientWorkload:
    """Build a registered workload: ``get_workload("dnn", sizes=(...))`` or
    ``get_workload("lora", arch="smollm-135m", reduced=True, rank=4)``."""
    if name not in WORKLOADS:
        raise ValueError(f"unknown workload {name!r}; expected {sorted(WORKLOADS)}")
    return WORKLOADS[name](**kwargs)


# ---------------------------------------------------------------------------
# the LLM workload's simulation on the fused engine
# ---------------------------------------------------------------------------


def make_llm_fused_data(model_cfg, *, clients: int, samples_per_client: int = 16,
                        seq: int = 32, n_test: int = 16, seed: int = 0, device="cuda"):
    """:class:`~repro_torch.fed.engine.FusedData` on ``device`` over the
    synthetic bigram-markov token stream: per-client ``(n, seq)`` int32
    token/label shards stacked to ``(K, n, seq)`` plus a held-out batch.  The
    tokens equal the JAX package's ``make_llm_fused_data`` exactly."""
    from repro_torch.data import make_token_stream, padded_stack
    from repro_torch.fed.engine import FusedData

    dev = resolve_device(device)
    need = (clients * samples_per_client + n_test) * (seq + 1)
    stream = make_token_stream(seed=seed, vocab=model_cfg.vocab_size, n=max(4 * need, 8_192))
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(clients):
        b = next(iter(stream.batches(rng, batch=samples_per_client, seq=seq, n_batches=1)))
        shards.append((np.asarray(b["tokens"], np.int32), np.asarray(b["labels"], np.int32)))
    x, y, lengths = padded_stack(shards)
    tb = next(iter(stream.batches(rng, batch=n_test, seq=seq, n_batches=1)))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return FusedData(
        x=t(x), y=t(y), lengths=t(lengths), n_k=t(lengths.astype(np.float32)),
        x_test=t(tb["tokens"]), y_test=t(tb["labels"]),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_llm_simulation(workload: TransformerLoraWorkload, **kwargs):
    """DEPRECATED: call :func:`repro_torch.fed.api.run` instead.  A thin shim
    over :func:`simulate_llm`, kept so existing callers keep working, with a
    warning."""
    warnings.warn(
        "run_llm_simulation is deprecated; use repro_torch.fed.api.run(workload, "
        "sim_config) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return simulate_llm(workload, **kwargs)


def simulate_llm(
    workload: TransformerLoraWorkload,
    *,
    clients: int = 6,
    byzantine: int = 2,
    rounds: int = 6,
    local_steps: int = 2,
    batch: int = 2,
    samples_per_client: int = 16,
    seq: int = 32,
    n_test: int = 16,
    seed: int = 0,
    lr: float = 0.2,
    scenario: str = "byzantine",
    rule: str = "afa",
    afa_variant: str = "iterative",
    kernel_plan=None,
    data=None,
    eager: bool = False,
    device="cuda",
):
    """Run the fused T-round simulation of the LLM workload and summarize.

    The round is the fused engine's body (``fed/engine.make_fused_sim``, the
    JAX package's with ``agg_layout="packed"``): the keyed device minibatch
    draw, local training of all K clients at once, non-trainers reset to the
    current adapters ``w_t``, the update-level attack ``scenario`` of the
    first ``byzantine`` clients on the adapter proposals, the ``(K,
    D_adapter)`` buffer through ``server_step`` (screening, reputation,
    blocking from the table), ``w_t`` kept when no client is live, the
    aggregate swapped in and the model scored.  On the card the round is
    captured once as a CUDA graph and replayed T times, on the CPU it runs
    in a loop; with ``eager`` the body is called once a round instead, the
    reference the graph is held to.  The server config is built here from
    ``rule`` as in the JAX package; ``afa_variant`` and ``kernel_plan`` pick
    the AFA route.  Returns the JAX package's dict of host results plus the
    ``(T, K)`` ``good_mask``, the per-round wall times (``round_times``,
    total / T, capture included) and the capture's seconds
    (``capture_time``, 0 without a graph).
    """
    from repro_torch.fed.engine import (
        EngineConfig,
        fused_eager_run,
        fused_server_state,
        make_fused_sim,
    )
    from repro_torch.fed.server import ServerConfig, make_rule_options

    dev = resolve_device(device)
    if data is None:
        data = make_llm_fused_data(
            workload.model_cfg, clients=clients, samples_per_client=samples_per_client,
            seq=seq, n_test=n_test, seed=seed, device=dev,
        )
    bad = np.zeros((clients,), bool)
    bad[:byzantine] = True

    cfg = EngineConfig(scenario=scenario, lr=lr, momentum=0.9, dropout=False)
    scfg = ServerConfig(
        rule=rule, num_clients=clients, num_byzantine=max(byzantine, 1),
        trim=max(min(byzantine, (clients - 1) // 2), 1), afa_variant=afa_variant,
        kernel_plan=kernel_plan,
    )
    scan_fn, round_fn = make_fused_sim(
        workload, cfg, rule=rule, opts=make_rule_options(scfg, clients),
        delta_block=scfg.delta_block, num_clients=clients, num_rounds=rounds,
        batch_s=local_steps, batch_b=batch, bad_mask=bad, alpha0=scfg.alpha0,
        beta0=scfg.beta0, device=dev,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params0 = workload.init_params(gen, dev)
    d_adapter = workload.proposal_dim(params0)
    d_total = workload.param_dim(params0)

    stats = {"capture_s": 0.0}
    _sync(dev)
    t_start = time.perf_counter()
    if eager:
        state0 = fused_server_state(clients, scfg.alpha0, scfg.beta0, dev)
        params, state, traj = fused_eager_run(round_fn, params0, state0, seed, data, rounds)
    else:
        params, state, traj = scan_fn(params0, seed, data, stats=stats)
    _sync(dev)
    total = time.perf_counter() - t_start

    good_mask = traj.good_mask.cpu().numpy()
    return {
        "test_error": traj.test_error.cpu().numpy(),
        "good_frac": good_mask.astype(np.float32).mean(axis=1),
        "good_mask": good_mask,
        "blocked": traj.blocked.cpu().numpy(),
        "rounds_blocked": state.rounds_blocked.cpu().numpy(),
        "bad_mask": bad,
        "adapter_dim": int(d_adapter),
        "param_dim": int(d_total),
        "adapter_fraction": float(d_adapter) / float(d_total),
        "params": params,
        "round_times": [total / max(rounds, 1)] * rounds,
        "capture_time": stats["capture_s"],
    }
