"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155.  GQA [hf:ibm-granite/granite-3.0-2b-base (8b variant)]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    activation="swiglu",
    sliding_window=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="vmap",
    fed_clients=16,
)
