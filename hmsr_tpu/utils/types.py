"""Dtype policy for the whole framework.

float32 everywhere on the compute path (parity with the reference dtype policy,
reference utils.py:16-23), complex64 for the FFT grey path, and a shared
division epsilon. The pipeline keeps f32 for numerical parity with the
reference output; matmuls that could otherwise run in TF32 on a GPU ask for
HIGHEST precision.
"""

import jax.numpy as jnp
import numpy as np

DEFAULT_FLOAT = jnp.float32
DEFAULT_NUMPY_FLOAT = np.float32
DEFAULT_COMPLEX = jnp.complex64

# Guard used by the analytic 2x2 inversions (reference utils.py:21).
EPSILON_DIV = 1e-10
