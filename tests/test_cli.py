"""CLI end-to-end: npz burst -> PNG output + robustness mask export."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hmsr_tpu.io.burst import save_npz_burst
from hmsr_tpu.io.synthetic import make_synthetic_burst, DEFAULT_CFA

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.skipif(not os.path.exists("/usr/bin/env"), reason="no shell")
def test_cli_png_output(tmp_path):
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=4,
                                            alpha=1.8e-4, beta=3.0e-6, seed=1)
    frames = np.concatenate([ref[None], comps])
    burst = tmp_path / "burst.npz"
    save_npz_burst(burst, frames, DEFAULT_CFA, [1, 1, 1], iso=100,
                   alpha=1.8e-4, beta=3.0e-6)
    out = tmp_path / "out.png"

    env = dict(os.environ, JAX_PLATFORMS="cpu", HMSR_MC_PATCHES="2000",
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    result = subprocess.run(
        [sys.executable, str(REPO / "run_handheld.py"),
         "--impath", str(burst), "--outpath", str(out),
         "scale=2", "verbose=0",
         "block_matching.tuning.factors=[1,2]",
         "block_matching.tuning.tile_size_factors=[1,1]",
         "block_matching.tuning.search_radii=[1,4]",
         "block_matching.tuning.metrics=['L1','L2']"],
        capture_output=True, text=True, env=env, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    assert out.exists()
    import cv2
    img = cv2.imread(str(out))
    assert img.shape == (256, 256, 3)
    assert out.with_suffix(".rob.png").exists()


def test_bench_variant_failure_propagates(monkeypatch, capsys):
    """A failing bench variant must land in failed_variants AND flip the
    exit code (the r02 dark-variant crash sailed through rc=0)."""
    import json
    import bench

    def fake_bench_size(h, w, n_frames, std, diff, n_runs=3,
                        brightness=None, tag="", mutate=None):
        if tag:
            raise RuntimeError("simulated dark-path crash")
        return 1.234

    import hmsr_tpu.noise as noise_mod
    curves = (np.full(1001, 0.01), np.full(1001, 0.01))
    monkeypatch.setattr(bench, "bench_size", fake_bench_size)
    monkeypatch.setattr(noise_mod, "run_fast_MC", lambda a, b: curves)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["value"] == 1.234
    names = {f["variant"] for f in out["failed_variants"]}
    assert names == {"dark", "dark64", "x1", "x3", "grey"}
    assert "simulated dark-path crash" in out["failed_variants"][0]["error"]
