"""Core utilities: dtype policy, timing, metrics.

Rebuild of the reference's ``utils.py`` (see its lines 16-23 for the dtype
policy it mirrors). One array library (jax.numpy), one float type (float32).
"""

from .types import (
    DEFAULT_FLOAT,
    DEFAULT_NUMPY_FLOAT,
    DEFAULT_COMPLEX,
    EPSILON_DIV,
)
from .timing import getTime, timer
from .metrics import compute_rmse, compute_psnr

__all__ = [
    "DEFAULT_FLOAT",
    "DEFAULT_NUMPY_FLOAT",
    "DEFAULT_COMPLEX",
    "EPSILON_DIV",
    "getTime",
    "timer",
    "compute_rmse",
    "compute_psnr",
]
