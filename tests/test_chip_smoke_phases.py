"""chip_smoke.py's heavier phases rehearsed on the CPU at tiny sizes,
the sharded phase on 4 of the virtual devices."""

import sys
from pathlib import Path

import pytest

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _cpu():
    return jax.devices("cpu")[0]


def test_phase_variants_tiny():
    burst = cs.make_burst(_cpu(), 256, 256, 3)
    out = cs.phase_variants(_cpu(), size=(256, 256), n_frames=3,
                            names=("x1", "x3", "grey"), bright_burst=burst)
    assert out["x1"]["out_shape"] == [256, 256, 3]
    assert out["x3"]["out_shape"] == [768, 768, 3]
    assert out["grey"]["out_shape"] == [512, 512, 1]
    assert all(v["interior_finite_fraction"] == 1.0 for v in out.values())


def test_phase_fast_paths_tiny():
    burst = cs.make_burst(_cpu(), 256, 256, 4)
    out = cs.phase_fast_paths(_cpu(), burst, merge_band_rows=200)
    assert set(out) == {"ica", "warp", "merge steerable", "merge iso", "slab",
                        "finishing gamma=False", "finishing gamma=True"}
    assert all(v["pass"] for v in out.values())


def test_phase_sharded_four_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    burst = cs.make_burst(_cpu(), 256, 256, 4)
    out = cs.phase_sharded(jax.devices()[:4], burst)
    assert out["4x1"]["pass"] and out["2x2"]["pass"]
    assert out["4x1"]["out_shape"] == [512, 512, 3]
