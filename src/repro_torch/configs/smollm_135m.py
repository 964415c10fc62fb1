"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    activation="swiglu",
    sliding_window=8192,  # enabled only for the long_500k shape
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="vmap",
    fed_clients=16,
)
