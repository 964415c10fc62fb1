"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Mamba2 backbone + SHARED attention block applied every 6
layers (one parameter set, per-application KV caches) [arXiv:2411.15242]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_every=6,
    sliding_window=4096,  # ring cache for shared attn blocks in long decode
    activation="gelu",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="vmap",
    fed_clients=16,
)
