"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Encoder-only (bidirectional), same backbone as wav2vec2 [arXiv:2106.07447].
Conv/mel feature extractor STUBBED (input_specs provides precomputed frame
embeddings, dim 512).  No decode step: decode_32k / long_500k are skipped
(see DESIGN.md §Arch-applicability)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    causal=False,
    frontend="frame",
    frontend_dim=512,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="vmap",
    fed_clients=16,
)
