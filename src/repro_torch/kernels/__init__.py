"""Hand-written CUDA kernels of the robust-aggregation hot path.

``csrc/afa_kernels.cu`` holds the kernels, ``build.py`` compiles and binds
them, ``ops.py`` is the checked public wrapper, ``ref.py`` the plain twins.
"""

from repro_torch.kernels.ops import (
    LAUNCH_COUNTS,
    afa_screen,
    cosine_sim,
    gram,
    reset_launch_counts,
    weighted_sum,
)

__all__ = [
    "LAUNCH_COUNTS",
    "afa_screen",
    "cosine_sim",
    "gram",
    "reset_launch_counts",
    "weighted_sum",
]
