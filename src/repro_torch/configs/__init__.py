"""Assigned-architecture registry.  ``get_config(arch_id)`` returns the exact
published configuration; every module cites its source in its docstring.

A copy of ``repro/configs``: the same ids, aliases and config data, built on
``repro_torch.models.ModelConfig``.  Only the dense family can be built by
``repro_torch.models.build_model`` so far.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi35_moe_42b",
    "granite3_8b",
    "nemotron4_340b",
    "smollm_135m",
    "paligemma_3b",
    "mamba2_1_3b",
    "olmoe_1b_7b",
    "llama3_8b",
    "zamba2_1_2b",
    "hubert_xlarge",
]

# public --arch ids (hyphenated, as assigned) -> module names
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "granite-3-8b": "granite3_8b",
    "nemotron-4-340b": "nemotron4_340b",
    "smollm-135m": "smollm_135m",
    "paligemma-3b": "paligemma_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3-8b": "llama3_8b",
    "zamba2-1.2b": "zamba2_1_2b",
    "hubert-xlarge": "hubert_xlarge",
}

# the paper's own experimental models
PAPER_IDS = ["paper_mnist_dnn", "paper_spambase_dnn"]


def get_config(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ALIASES}
