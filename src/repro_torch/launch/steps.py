"""Step builders: the functions the dry run counts and a launcher runs.

Counterpart of ``repro/launch/steps.py``.  One builder per step kind; each
returns a function whose positional arguments follow
``repro_torch.launch.specs.input_specs``.  The reference's mesh is replaced
by ``client_rows`` (``specs.fed_client_count``); its ``client_axes`` name
mesh axes and have no counterpart on one card.
"""

from __future__ import annotations

from repro_torch.core.afa import AFAConfig
from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
from repro_torch.launch.specs import LOCAL_STEPS, fed_client_count


def train_round_config(cfg, client_rows: int = 1, *, afa_variant: str = "iterative",
                       lr: float = 0.02, proposal_dtype: str = "bfloat16",
                       local_steps: int = LOCAL_STEPS, microbatch: int = 1) -> FedRoundConfig:
    """The federated round ``make_train_step`` builds: one AFA screening
    pass under ``remat``, else up to 4."""
    return FedRoundConfig(
        num_clients=fed_client_count(cfg, client_rows),
        local_steps=local_steps,
        lr=lr,
        afa=AFAConfig(variant=afa_variant, max_rounds=1 if cfg.fed_mode == "remat" else 4),
        mode=cfg.fed_mode,
        proposal_dtype=proposal_dtype,
        microbatch=microbatch,
    )


def make_train_step(model, client_rows: int = 1, *, afa_variant: str = "iterative",
                    lr: float = 0.02, proposal_dtype: str = "bfloat16",
                    local_steps: int = LOCAL_STEPS, microbatch: int = 1):
    """``fed_round(params, rep, n_k, batch) -> (params', rep', metrics)``
    (``fed.distributed.make_fed_round``)."""
    return make_fed_round(model, train_round_config(
        model.config, client_rows, afa_variant=afa_variant, lr=lr,
        proposal_dtype=proposal_dtype, local_steps=local_steps, microbatch=microbatch))


def make_prefill_step(model, *, cache_size: int, use_window: bool = False):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_size=cache_size, use_window=use_window)

    return prefill_step


def make_forward_step(model):
    def forward_step(params, batch):
        return model.forward(params, batch)

    return forward_step


def make_serve_step(model, *, ring: bool = False):
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ring=ring)

    return serve_step


def build_step(model, bundle, **train_kwargs):
    """SpecBundle -> its step function."""
    if bundle.step_kind == "train":
        return make_train_step(model, bundle.meta["client_rows"], **train_kwargs)
    if bundle.step_kind == "prefill":
        return make_prefill_step(model, cache_size=bundle.meta["cache_size"])
    if bundle.step_kind == "forward":
        return make_forward_step(model)
    if bundle.step_kind == "decode":
        return make_serve_step(model, ring=bundle.meta["ring"])
    raise ValueError(bundle.step_kind)
