"""Profiling knobs must refuse to run without HMSR_DEBUG_TRUNC=1.

Both knobs (tpu.align_levels, tpu.rob_trunc) silently corrupt output when
active; a stray config key from a profiling session must fail loudly, not
poison production runs.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hmsr_tpu.configs import default_config, update_snr_config
from hmsr_tpu.models.alignment import align, init_alignment
from hmsr_tpu.models.robustness import compute_robustness, init_robustness

CFA = np.array([[0, 1], [1, 2]])
WB = [1.0, 1.0, 1.0]


def _config(**tpu):
    c = default_config()
    c.block_matching.tuning.factors = [1, 2]
    c.block_matching.tuning.tile_size_factors = [1, 1]
    c.block_matching.tuning.search_radii = [1, 4]
    c.block_matching.tuning.metrics = ["L1", "L2"]
    update_snr_config(c, 25)
    c.noise_model.alpha = 1.8e-4
    c.noise_model.beta = 3.0e-6
    c.tpu.update(tpu)
    return c


def _align(c):
    img = jnp.asarray(np.random.RandomState(0).rand(64, 64).astype(np.float32))
    return align(init_alignment(img, c), img, c)


def _robustness(c):
    rng = np.random.RandomState(1)
    raw = jnp.asarray(rng.rand(64, 64).astype(np.float32))
    curve = jnp.full((1001,), 0.01, jnp.float32)
    stats = init_robustness(raw, CFA, WB, (curve, curve), c)
    flow = jnp.zeros((4, 4, 2), jnp.float32)
    return compute_robustness(raw, stats, flow, CFA, WB, c)


def test_align_levels_refuses_without_gate(monkeypatch):
    monkeypatch.delenv("HMSR_DEBUG_TRUNC", raising=False)
    with pytest.raises(ValueError, match="align_levels"):
        _align(_config(align_levels=1))


def test_align_levels_allowed_with_gate(monkeypatch):
    monkeypatch.setenv("HMSR_DEBUG_TRUNC", "1")
    flow = np.asarray(_align(_config(align_levels=1)))
    assert flow.shape == (4, 4, 2)


def test_align_levels_off_by_default(monkeypatch):
    monkeypatch.delenv("HMSR_DEBUG_TRUNC", raising=False)
    assert "align_levels" not in default_config().tpu
    assert np.isfinite(np.asarray(_align(_config()))).all()


def test_rob_trunc_refuses_without_gate(monkeypatch):
    monkeypatch.delenv("HMSR_DEBUG_TRUNC", raising=False)
    with pytest.raises(ValueError, match="rob_trunc"):
        _robustness(_config(rob_trunc=2))


def test_rob_trunc_allowed_with_gate(monkeypatch):
    monkeypatch.setenv("HMSR_DEBUG_TRUNC", "1")
    r = np.asarray(_robustness(_config(rob_trunc=2)))
    assert r.shape == (64, 64)


def test_rob_trunc_off_by_default(monkeypatch):
    monkeypatch.delenv("HMSR_DEBUG_TRUNC", raising=False)
    assert "rob_trunc" not in default_config().tpu
    r = np.asarray(_robustness(_config()))
    assert ((r >= 0) & (r <= 1)).all()
