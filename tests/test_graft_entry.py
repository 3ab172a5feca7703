"""Driver entry-point contract tests (run on the virtual CPU mesh)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as ge


def test_entry_compiles_and_runs():
    fn, args = ge.entry()
    img, debug = jax.jit(fn)(*args)
    jax.block_until_ready(img)
    assert img.shape == (256, 256, 3)
    assert bool(np.isfinite(np.asarray(img)[8:-8, 8:-8]).all())


def test_dryrun_multichip():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ge.dryrun_multichip(8)
