from repro_torch.models.config import ModelConfig, validate
from repro_torch.models.model import Model, build_model

__all__ = ["ModelConfig", "validate", "Model", "build_model"]
