"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1, head_dim=256)
d_ff=16384 vocab=257216.  SigLIP vision encoder STUBBED (input_specs provides
256 precomputed patch embeddings, dim 1152); gemma decoder with prefix-LM
masking over the image tokens [arXiv:2407.07726]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    frontend="patch",
    frontend_dim=1152,   # SigLIP-So400m output width
    prefix_len=256,      # 224px / 14px patches -> 256 image tokens
    sliding_window=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="vmap",
    fed_clients=16,
)
