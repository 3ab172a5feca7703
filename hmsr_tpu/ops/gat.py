"""Generalized Anscombe Transform (variance stabilization).

Elementwise op (the reference launches a dedicated CUDA kernel for this,
utils_image.py:117-170); XLA fuses it into the consumer. Noise model:
``std^2 = alpha * I + beta`` with ISO-dependent alpha/beta.
"""

import jax.numpy as jnp


def gat(image, alpha, beta):
    """VST: ``2/alpha * sqrt(max(alpha*I + 3/8*alpha^2 + beta, 0))``."""
    assert alpha > 0, (
        f"alpha should be positive, got {alpha} (VST is ill defined and kernels "
        f"would be wrong)")
    vst = alpha * image + (3.0 / 8.0) * alpha * alpha + beta
    vst = jnp.maximum(vst, 0.0)
    return (2.0 / alpha) * jnp.sqrt(vst)
