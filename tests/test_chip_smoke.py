"""chip_smoke.py rehearsed on the CPU: the script's contract and its
cheaper phases at tiny sizes (tests/test_chip_smoke_phases.py has the
rest)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _cpu():
    return jax.devices("cpu")[0]


def test_script_without_gpu_fails_and_prints_no_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=str(REPO))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_ok_line_format(monkeypatch, capsys):
    """main() prints the contract's last line once every phase passed."""
    dev = _cpu()
    calls = []
    for name in ("phase_device", "phase_main_path", "phase_variants",
                 "phase_parity", "phase_fast_paths"):
        monkeypatch.setattr(cs, name,
                            lambda *a, _n=name, **k: calls.append(_n) or {})
    monkeypatch.setattr(cs, "make_burst", lambda *a, **k: np.zeros((2, 4, 4)))

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()] if not a
                        else [dev])
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert calls == ["phase_device", "phase_main_path", "phase_variants",
                     "phase_parity", "phase_fast_paths"]


def test_failing_phase_prints_no_ok_line(monkeypatch, capsys):
    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    def boom(*a, **k):
        raise AssertionError("phase failed")

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    monkeypatch.setattr(cs, "phase_device", lambda *a, **k: {})
    monkeypatch.setattr(cs, "make_burst", lambda *a, **k: np.zeros((2, 4, 4)))
    monkeypatch.setattr(cs, "phase_main_path", boom)
    with pytest.raises(AssertionError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_phase_device_reports_jax_device(capsys):
    out = cs.phase_device(_cpu())
    assert out["platform"] == "cpu"
    assert out["count"] == len(jax.devices())
    assert out["nvidia_smi"]
    assert "[device]" in capsys.readouterr().out


def test_make_burst_is_seeded_and_shifted():
    a = cs.make_burst(_cpu(), 64, 96, 3, seed=3)
    b = cs.make_burst(_cpu(), 64, 96, 3, seed=3)
    assert a.shape == (3, 64, 96) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert 0.0 <= a.min() and a.max() <= 1.0
    # frames differ (sub-pixel shifts and noise), the scene is shared
    assert np.abs(a[1] - a[0]).mean() > 1e-3
    assert np.corrcoef(a[0].ravel(), a[1].ravel())[0, 1] > 0.5


def test_phase_main_path_tiny():
    burst = cs.make_burst(_cpu(), 256, 256, 3)
    out = cs.phase_main_path(_cpu(), burst)
    assert out["out_shape"] == [512, 512, 3]
    assert out["interior_finite_fraction"] == 1.0
    assert out["cold_s"] > 0 and out["second_s"] > 0


def test_phase_parity_tiny():
    out = cs.phase_parity(_cpu(), _cpu(), tiers=(("ts16", 128, 16),))
    assert out["ts16"]["pass"]
    assert out["ts16"]["flow_max"] == 0.0
