"""ClientWorkload — the pluggable client-training layer.

Counterpart of ``repro/fed/workload.py`` (``ClientWorkload``, the proposal
codec and ``DnnWorkload``; the LoRA workload is not ported).  A workload
builds the model (``init_params``), runs local training for all K clients at
once (``local_update``, returning a stacked proposal tree), maps params to
proposal space and back (``codec``) and scores the model (``eval_metric``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.attacks import stream_seed
from repro_torch.fed.client import local_sgd
from repro_torch.fed.dnn import dnn_error, dnn_loss, init_dnn
from repro_torch.utils.trees import tree_broadcast_clients


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


class ClientWorkload:
    """Protocol base (subclasses are frozen dataclasses)."""

    name: str = "abstract"
    codec: ProposalCodec = IDENTITY_CODEC

    def init_params(self, generator: torch.Generator, device):
        raise NotImplementedError

    def local_update(self, cfg, params, batches, client_seeds):
        """Local training of K clients from the global ``params`` ->
        stacked proposal tree.  ``batches`` leaves are ``(K, S, b, ...)``;
        ``client_seeds`` holds one torch-generator seed per row."""
        raise NotImplementedError

    def eval_metric(self, params, x_test, y_test):
        """Scalar error in [0, 1] on the held-out set."""
        raise NotImplementedError


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

    def local_update(self, cfg, params, batches, client_seeds):
        K = len(client_seeds)
        x = batches["x"]
        keep = (self.dropout_keep(client_seeds, x.shape[1], x.shape[2], x.device)
                if cfg.dropout else None)
        return local_sgd(
            dnn_loss, tree_broadcast_clients(params, K), batches,
            lr=cfg.lr, momentum=cfg.momentum, dropout_keep=keep,
        )

    def eval_metric(self, params, x_test, y_test):
        return dnn_error(params, x_test, y_test)
