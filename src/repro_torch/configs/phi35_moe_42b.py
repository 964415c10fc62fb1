"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

fed_mode="scan": 42B total params -> clients run sequentially, proposals
stored bf16 sharded over the full mesh (FSDP layout)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    top_k=2,
    activation="swiglu",
    sliding_window=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="scan",
    fed_clients=8,
)
