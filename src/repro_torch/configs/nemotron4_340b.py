"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  GQA, squared-ReLU MLP (2 matrices) [arXiv:2402.16819].

fed_mode="remat": at 340B params the K client proposals cannot be stored —
the federated round streams clients in 3 passes (see repro.fed.distributed).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    sliding_window=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fed_mode="remat",
    fed_clients=4,
)
