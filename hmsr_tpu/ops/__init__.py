"""Low-level image / math ops (the reference's device-kernel layer, L4).

Every Numba-CUDA kernel and Torch-CUDA op of the reference maps to a fused
XLA expression in this package (see SURVEY.md section 2.2 for the full
inventory). All ops are pure functions on jnp arrays, vmap-able,
and shape-static under jit.
"""

from .linalg2x2 import (
    eigen_2x2,
    invert_2x2,
    solve_2x2,
    quad_mat_prod,
)
from .dogson import dogson_quadratic_kernel, dogson_biquadratic_kernel
from .grey import fft_lowpass_grey, decimate_to_grey, compute_grey_image
from .gat import gat
from .pyramid import gaussian_kernel1d, downsample, build_gaussian_pyramid
from .stencils import local_stats_3x3, local_min_5x5, box_sum_valid
from .gradients import sobel_gradients, halfpixel_gradients

__all__ = [
    "eigen_2x2", "invert_2x2", "solve_2x2", "quad_mat_prod",
    "dogson_quadratic_kernel", "dogson_biquadratic_kernel",
    "fft_lowpass_grey", "decimate_to_grey", "compute_grey_image",
    "gat",
    "gaussian_kernel1d", "downsample", "build_gaussian_pyramid",
    "local_stats_3x3", "local_min_5x5", "box_sum_valid",
    "sobel_gradients", "halfpixel_gradients",
]
