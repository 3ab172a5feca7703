"""Tiny-size production-composition tests for the DEFAULT gate.

Each test here is a minimal representative of one production-path family:

- process_arrays called twice with the explicit matmul grey backend
  (a trace-cache crash once hid there),
- the frames-vmapped analysis pipeline against the scan pipeline.
"""

import numpy as np

import jax.numpy as jnp


def test_process_twice_matmul_grey_tiny():
    from hmsr_tpu.configs import default_config
    from hmsr_tpu.models.process import process_arrays
    from hmsr_tpu.ops.grey import _CIRC_CACHE

    _CIRC_CACHE.clear()
    rng = np.random.RandomState(1)
    frames = rng.rand(2, 32, 32).astype(np.float32) * 0.5 + 0.25
    config = default_config()
    config.scale = 1
    config.verbose = 0
    config.block_matching.tuning.factors = [1, 2]
    config.block_matching.tuning.tile_size_factors = [1, 1]
    config.block_matching.tuning.search_radii = [1, 4]
    config.block_matching.tuning.metrics = ["L1", "L2"]
    config.tpu.grey_impl = "matmul"
    config.noise_model.alpha = 1.8e-4
    config.noise_model.beta = 3.0e-6
    out1, _ = process_arrays(frames[0], frames[1:], config)
    out2, _ = process_arrays(frames[0], frames[1:], config)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-6)


def test_vmapped_pipeline_matches_scan_tiny():
    """tpu.pipeline="vmapped" (frames-batched analysis, merge-only scan)
    must match the scan pipeline; both run the tiled per-frame merge."""
    from tests.test_parallel import (DEFAULT_CFA, WB, curves,
                                     make_synthetic_burst, small_config,
                                     ALPHA, BETA)
    from hmsr_tpu.models.pipeline import make_pipeline

    ref, comps, _, _ = make_synthetic_burst(32, 32, n_frames=4, alpha=ALPHA,
                                            beta=BETA, seed=29)
    std, diff = curves()

    outs = {}
    for mode in ("scan", "vmapped"):
        c = small_config()
        c.tpu.pipeline = mode
        c.tpu.merge_impl = "tiled"
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        img, dbg = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        outs[mode] = (np.nan_to_num(np.asarray(img)),
                      np.asarray(dbg["accumulated_robustness"]))
    np.testing.assert_allclose(outs["vmapped"][0], outs["scan"][0],
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(outs["vmapped"][1], outs["scan"][1],
                               atol=1e-4, rtol=1e-4)
