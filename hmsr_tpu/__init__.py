"""hmsr_tpu — Handheld Multi-frame Super-Resolution in JAX.

A from-scratch JAX/XLA implementation of the Handheld Multi-Frame
Super-Resolution pipeline (Wronski et al., SIGGRAPH 2019; IPOL 2023
companion), with the same capabilities as the Numba-CUDA reference
implementation: one runtime (XLA), one array type (jnp), the pipeline jitted
end-to-end, the burst processed with ``lax.scan`` over device-resident
frames. It runs on an NVIDIA GPU, and on the CPU for tests.
"""

__version__ = "0.1.0"

from .configs import default_config, load_yaml, merge, update  # noqa: F401


def process(burst_path, config=None):
    """Process a raw burst folder into an RGB image (public API).

    Mirrors the reference ``process(burst_path, config)`` entry point
    (reference super_resolution.py:203). Imported lazily to keep base import
    light.
    """
    from .models.process import process as _process
    return _process(burst_path, config)
