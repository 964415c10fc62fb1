"""Step builders: the functions the dry run counts and a launcher runs.

Counterpart of ``repro/launch/steps.py``.  One builder per step kind; each
returns a function whose positional arguments follow
``repro_torch.launch.specs.input_specs``.  Where the reference takes a mesh,
``client_rows`` is its number of client rows (``specs.fed_client_count``)
or a mesh.  Under ``vmap`` a mesh sets ``client_axes`` to its client rows
(``client_row_axes``), as the reference does; a ``GridMesh`` also runs the
round on its ranks (``fed.distributed.make_fed_round(..., grid=)``).

A model built on a grid runs on it: the train step of its bundle
(``input_specs(model, shape, grid)``) is the grid's round, and its
prefill, forward and decode steps run on this rank's blocks, the decode
step told the whole cache's slots (``bundle.meta["cache_size"]``), as the
reference's ``build_step(model, bundle, mesh)`` lowers them on its mesh.
The train step of a model whose config sets a mesh lever
(``activation_sharding``, ``seq_par_attention``, ``fsdp_activations``: the
dry run's ``act_shard``, ``seq_par`` and ``fsdp_act`` variants) runs it on
the grid (``models/model.py``).
"""

from __future__ import annotations

from repro_torch.core.afa import AFAConfig
from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
from repro_torch.launch.mesh import GridMesh, client_row_axes
from repro_torch.launch.specs import LOCAL_STEPS, fed_client_count


def train_round_config(cfg, client_rows=1, *, afa_variant: str = "iterative",
                       lr: float = 0.02, proposal_dtype: str = "bfloat16",
                       local_steps: int = LOCAL_STEPS, microbatch: int = 1) -> FedRoundConfig:
    """The federated round ``make_train_step`` builds: one AFA screening
    pass under ``remat``, else up to 4; under ``vmap`` on a mesh, the
    clients on its client rows."""
    mesh = None if isinstance(client_rows, int) else client_rows
    return FedRoundConfig(
        num_clients=fed_client_count(cfg, client_rows),
        local_steps=local_steps,
        lr=lr,
        afa=AFAConfig(variant=afa_variant, max_rounds=1 if cfg.fed_mode == "remat" else 4),
        mode=cfg.fed_mode,
        proposal_dtype=proposal_dtype,
        microbatch=microbatch,
        client_axes=(client_row_axes(mesh) or None)
        if mesh is not None and cfg.fed_mode == "vmap" else None,
    )


def make_train_step(model, client_rows=1, *, afa_variant: str = "iterative",
                    lr: float = 0.02, proposal_dtype: str = "bfloat16",
                    local_steps: int = LOCAL_STEPS, microbatch: int = 1):
    """``fed_round(params, rep, n_k, batch) -> (params', rep', metrics)``
    (``fed.distributed.make_fed_round``); on a ``GridMesh`` over its
    ranks."""
    grid = client_rows if isinstance(client_rows, GridMesh) else None
    return make_fed_round(model, train_round_config(
        model.config, client_rows, afa_variant=afa_variant, lr=lr,
        proposal_dtype=proposal_dtype, local_steps=local_steps, microbatch=microbatch),
        grid=grid)


def make_prefill_step(model, *, cache_size: int, use_window: bool = False):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_size=cache_size, use_window=use_window)

    return prefill_step


def make_forward_step(model):
    def forward_step(params, batch):
        return model.forward(params, batch)

    return forward_step


def make_serve_step(model, *, ring: bool = False, cache_size: int | None = None):
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ring=ring, cache_size=cache_size)

    return serve_step


def build_step(model, bundle, **train_kwargs):
    """SpecBundle -> its step function."""
    if bundle.step_kind == "train":
        grid = model.grid if isinstance(model.grid, GridMesh) else None
        return make_train_step(model, grid or bundle.meta["client_rows"], **train_kwargs)
    if bundle.step_kind == "prefill":
        return make_prefill_step(model, cache_size=bundle.meta["cache_size"])
    if bundle.step_kind == "forward":
        return make_forward_step(model)
    if bundle.step_kind == "decode":
        return make_serve_step(model, ring=bundle.meta["ring"],
                               cache_size=bundle.meta["cache_size"])
    raise ValueError(bundle.step_kind)
