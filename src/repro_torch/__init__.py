"""PyTorch + CUDA port of the AFA reproduction in ``repro``.

Module paths and public names mirror the JAX package (``repro_torch.fed.api
.run``, ``repro_torch.core.afa.afa_aggregate``, ...).  The package imports
torch, numpy and scipy only, never jax and nothing of ``repro``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    A CUDA device raises when CUDA is missing: an entry point never moves to
    the CPU on its own.  On the card, TF32 is switched off for matmuls and
    convolutions, because the JAX reference computes in full float32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the port on the CPU"
            )
        # full f32 products, as the f32 JAX reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    return dev
