"""Hand-written CUDA kernels of the robust-aggregation hot path.

``csrc/afa_kernels.cu`` (AFA's weighted sum, cosine, Gram and screen),
``csrc/rank_kernels.cu`` (coordinate-wise median and trimmed mean) and
``csrc/attn_kernels.cu`` (flash attention, forward) hold the kernels,
``build.py`` compiles and binds them, ``ops.py`` is the checked public
wrapper, ``ref.py`` the plain twins.
"""

from repro_torch.kernels.ops import (
    LAUNCH_COUNTS,
    afa_screen,
    coord_median,
    cosine_sim,
    flash_attention,
    gram,
    pairwise_sq_dists_from_gram,
    reset_launch_counts,
    trimmed_mean,
    weighted_sum,
)

__all__ = [
    "LAUNCH_COUNTS",
    "afa_screen",
    "coord_median",
    "cosine_sim",
    "flash_attention",
    "gram",
    "pairwise_sq_dists_from_gram",
    "reset_launch_counts",
    "trimmed_mean",
    "weighted_sum",
]
