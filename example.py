"""Library-usage demo (reference example.py analogue).

Generates a synthetic raw burst (no DNGs needed), merges a custom config over
the defaults, runs the pipeline through the public API, and saves the result.
Runs on JAX's default device (``JAX_PLATFORMS=cpu`` selects the CPU).
"""

import numpy as np

from hmsr_tpu.configs import default_config, merge
from hmsr_tpu.io.synthetic import make_synthetic_burst, DEFAULT_CFA
from hmsr_tpu.models.process import process_arrays
from hmsr_tpu.utils.compile_cache import enable_compile_cache

custom = {
    "scale": 2,
    "verbose": 1,
    "noise_model": {"alpha": 1.8e-4, "beta": 3.0e-6},
    "block_matching": {"tuning": {
        "factors": [1, 2], "tile_size_factors": [1, 1],
        "search_radii": [1, 4], "metrics": ["L1", "L2"]}},
    "postprocessing": {"enabled": True, "do_tonemapping": False},
}

if __name__ == "__main__":
    enable_compile_cache()
    config = merge(default_config(), custom)
    ref, comps, truth, _ = make_synthetic_burst(256, 256, n_frames=8,
                                                alpha=1.8e-4, beta=3.0e-6)
    image, debug = process_arrays(ref, comps, config, cfa=DEFAULT_CFA)
    image = np.clip(np.nan_to_num(image), 0, 1)
    try:
        import cv2
        cv2.imwrite("example_out.png",
                    cv2.cvtColor((image * 255 + 0.5).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        print("saved example_out.png", image.shape)
    except ImportError:
        np.save("example_out.npy", image)
        print("saved example_out.npy", image.shape)
