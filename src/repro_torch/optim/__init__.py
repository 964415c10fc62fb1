from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adamw,
    cosine_schedule,
    linear_warmup,
    sgd_momentum,
)

__all__ = ["OptState", "Optimizer", "sgd_momentum", "adamw", "cosine_schedule",
           "linear_warmup"]
