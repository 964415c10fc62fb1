"""Unified model configuration of every family of the JAX package.

Counterpart of ``repro/models/config.py``: the same fields and defaults, so
a config of the JAX package and its port describe the same model.
``pdtype``/``cdtype`` are torch dtypes.  ``fed_mode`` and ``microbatch``
pick the client-memory mode and the gradient-accumulation chunks of
``repro_torch.launch.train``'s rounds (``fed.distributed``).  The mesh levers
(``activation_sharding``, ``fsdp_activations``, ``seq_par_attention``) act
on a grid's ``model`` axis of more than one rank (``build_model(cfg,
grid=)``), where the reference's sharding constraints would, as explicit
splits of the forward's work: ``activation_sharding`` the attention's q
heads where the split cuts a kv head (``models/blocks.py``) and the
Mamba-2 SSD's heads (``models/ssm.py``), ``seq_par_attention`` the query
blocks of the plain blocked attention on a cut head, ``fsdp_activations``
each client's rows, every leaf gathered whole at its use
(``models/layers.py``).  On one card they change nothing, and the
prefill and the decode step take none.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (unused for pure SSM)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    causal: bool = True
    sliding_window: int = 0  # 0 = full attention; >0 = window (tokens)
    prefix_len: int = 0      # prefix-LM bidirectional span (VLM image tokens)
    # MLP
    d_ff: int = 0
    activation: str = "swiglu"  # swiglu | squared_relu | gelu | geglu
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # hybrid (zamba2-style): apply the shared attention block every N layers
    shared_attn_every: int = 0
    # modality frontend stub: "none" (tokens) | "patch" (VLM) | "frame" (audio)
    frontend: str = "none"
    frontend_dim: int = 0
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # attention blocking of the plain blocked attention
    block_q: int = 512
    block_k: int = 512
    # fed-integration knobs
    fed_mode: str = "vmap"  # vmap | scan | remat (fed.distributed)
    fed_clients: int = 16
    activation_sharding: bool = False  # mesh lever: heads over model (see the docstring)
    microbatch: int = 1  # gradient-accumulation chunks a local step (fed.distributed)
    fsdp_activations: bool = False  # mesh lever: a client's rows over model
    seq_par_attention: bool = False  # mesh lever: query blocks over model
    # attention through the hand-written flash kernel (kernels.ops
    # .flash_attention) for forward (causal or full, no prefix-LM);
    # $REPRO_TORCH_KERNELS=torch vetoes it
    use_pallas_attention: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "audio", "hybrid")

    @property
    def is_encoder(self) -> bool:
        return self.family == "audio"

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts — runnable in seconds on CPU."""
        d = min(self.d_model, 256)
        nh = max(2, min(self.num_heads, 4)) if self.num_heads else 0
        nkv = max(1, min(self.num_kv_heads, nh)) if self.num_kv_heads else 0
        while nkv > 1 and nh % nkv:  # keep GQA grouping valid
            nkv -= 1
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=(d // nh) if nh else 0,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            block_q=64,
            block_k=64,
            ssm_chunk=32,
            ssm_head_dim=32,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            prefix_len=min(self.prefix_len, 8) if self.prefix_len else 0,
            frontend_dim=d if self.frontend != "none" else 0,
            shared_attn_every=1 if self.shared_attn_every else 0,
            fed_clients=4,
        )
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2))
        return self.with_(**kw)


def validate(cfg: ModelConfig) -> None:
    if cfg.has_attention and cfg.family != "hybrid":
        assert cfg.num_heads > 0 and cfg.num_kv_heads > 0
        assert cfg.num_heads % cfg.num_kv_heads == 0
    if cfg.family in ("ssm", "hybrid"):
        assert cfg.ssm_state > 0
        assert cfg.d_inner % cfg.ssm_head_dim == 0
    if cfg.family == "moe":
        assert 0 < cfg.top_k <= cfg.num_experts
    if cfg.family == "vlm":
        assert cfg.frontend == "patch" and cfg.prefix_len > 0
    if cfg.family == "audio":
        assert cfg.frontend == "frame" and not cfg.causal
