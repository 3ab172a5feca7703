"""Alignment tests: known-shift recovery, backend equivalence, conventions.

Flow convention (matching the merge stage): ``moving[p + flow] ~ ref[p]``, so
a moving image equal to the reference translated by (dx, dy) must produce a
flow of (dx, dy).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hmsr_tpu.configs import default_config, update_snr_config
from hmsr_tpu.models.alignment import init_alignment, align, upscale_flow
from hmsr_tpu.models.block_matching import (
    extract_flow_patches, match_l1, match_l2, _direct_correlation,
    _fft_correlation,
)
from hmsr_tpu.models.ica import init_ica, refine_ica


def smooth_image(h, w, seed=0):
    """Bandlimited random image (so bilinear warping is accurate)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(h // 8, w // 8)
    up = np.kron(img, np.ones((8, 8)))
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(up, 3.0).astype(np.float32)


def shifted(img, dx, dy):
    """moving[y, x] = img[y - dy, x - dx] via spectral (exact) shift."""
    h, w = img.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    phase = np.exp(-2j * np.pi * (fy * dy + fx * dx))
    return np.real(np.fft.ifft2(np.fft.fft2(img) * phase)).astype(np.float32)


def small_config(ts=16, factors=(1, 2), radii=(2, 4), metrics=("L2", "L2")):
    c = default_config()
    c.block_matching.tuning.tile_size = ts
    c.block_matching.tuning.factors = list(factors)
    c.block_matching.tuning.tile_size_factors = [1] * len(factors)
    c.block_matching.tuning.search_radii = list(radii)
    c.block_matching.tuning.metrics = list(metrics)
    update_snr_config(c, 20)
    return c


class TestExtractPatches:
    def test_gather_matches_numpy(self):
        rng = np.random.RandomState(1)
        img = rng.rand(40, 48).astype(np.float32)
        flow = rng.randint(-3, 4, size=(2, 3, 2)).astype(np.float32)
        ts, r = 16, 2
        got = np.asarray(extract_flow_patches(jnp.asarray(img), jnp.asarray(flow), ts, r))
        for ty in range(2):
            for tx in range(3):
                for i in range(ts + 2 * r):
                    for j in range(ts + 2 * r):
                        y = min(max(ty * ts + int(flow[ty, tx, 1]) + i - r, 0), 39)
                        x = min(max(tx * ts + int(flow[ty, tx, 0]) + j - r, 0), 47)
                        assert got[ty, tx, i, j] == img[y, x]


class TestCorrelationBackends:
    def test_direct_equals_fft(self):
        rng = np.random.RandomState(2)
        ts, r = 16, 3
        tiles = rng.rand(3, 4, ts, ts).astype(np.float32)
        search = rng.rand(3, 4, ts + 2 * r, ts + 2 * r).astype(np.float32)
        direct = np.asarray(_direct_correlation(jnp.asarray(tiles), jnp.asarray(search), ts, r))
        pad = jnp.pad(jnp.asarray(tiles), ((0, 0), (0, 0), (r, r), (r, r)))
        fft = np.asarray(_fft_correlation(jnp.fft.rfft2(pad), jnp.asarray(search), ts, r))
        np.testing.assert_allclose(direct, fft, atol=1e-3)


class TestBlockMatching:
    @pytest.mark.parametrize("shift", [(0, 0), (2, -1), (-3, 3)])
    def test_l2_recovers_integer_shift(self, shift):
        dx, dy = shift
        img = smooth_image(64, 64)
        mov = np.roll(img, (dy, dx), axis=(0, 1))
        ts, r = 16, 4
        tiles = jnp.asarray(img.reshape(4, ts, 4, ts).transpose(0, 2, 1, 3))
        flow0 = jnp.zeros((4, 4, 2), jnp.float32)
        flow = np.asarray(match_l2(tiles, jnp.asarray(mov), flow0, ts, r))
        inner = flow[1:-1, 1:-1]
        np.testing.assert_allclose(inner[..., 0], dx, atol=0)
        np.testing.assert_allclose(inner[..., 1], dy, atol=0)

    @pytest.mark.parametrize("shift", [(1, 0), (-2, 2)])
    def test_l1_recovers_integer_shift(self, shift):
        dx, dy = shift
        img = smooth_image(64, 64, seed=3)
        mov = np.roll(img, (dy, dx), axis=(0, 1))
        ts, r = 16, 2
        flow0 = jnp.zeros((4, 4, 2), jnp.float32)
        flow = np.asarray(match_l1(jnp.asarray(img), jnp.asarray(mov), flow0, ts, r))
        inner = flow[1:-1, 1:-1]
        np.testing.assert_allclose(inner[..., 0], dx, atol=0)
        np.testing.assert_allclose(inner[..., 1], dy, atol=0)


class TestICA:
    @pytest.mark.parametrize("shift", [(0.3, -0.2), (-0.45, 0.4)])
    def test_recovers_subpixel_shift(self, shift):
        dx, dy = shift
        img = smooth_image(64, 64, seed=4)
        mov = shifted(img, dx, dy)
        ts = 16
        state = init_ica(jnp.asarray(img), ts)
        flow0 = jnp.zeros((4, 4, 2), jnp.float32)
        flow = np.asarray(refine_ica(jnp.asarray(img), state, jnp.asarray(mov),
                                     flow0, ts, n_iter=8))
        inner = flow[1:-1, 1:-1]
        np.testing.assert_allclose(inner[..., 0], dx, atol=0.08)
        np.testing.assert_allclose(inner[..., 1], dy, atol=0.08)

    def test_singular_hessian_keeps_flow(self):
        img = jnp.zeros((32, 32), jnp.float32)   # flat -> zero Hessian
        state = init_ica(img, 16)
        flow0 = jnp.full((2, 2, 2), 1.5, jnp.float32)
        flow = np.asarray(refine_ica(img, state, img, flow0, 16, n_iter=3))
        np.testing.assert_allclose(flow, 1.5)


class TestUpscaleFlow:
    def test_nearest_repeat_and_scale(self):
        c = small_config(ts=16, factors=(1, 2), radii=(1, 4), metrics=("L1", "L2"))
        flow = jnp.asarray(np.arange(2 * 2 * 2, dtype=np.float32).reshape(2, 2, 2))
        # list_id 0: new_ts 16, prev_ts 16, factor = factors[1] = 2 -> repeat 2
        up = np.asarray(upscale_flow(flow, (5, 4), 0, c))
        assert up.shape == (5, 4, 2)
        assert up[0, 0, 0] == flow[0, 0, 0] * 2
        assert up[1, 1, 0] == flow[0, 0, 0] * 2        # repeated block
        assert np.all(up[4, :, :] == 0)                # padded row


class TestFullAlign:
    @pytest.mark.parametrize("shift", [(2.3, -1.6)])
    def test_recovers_global_shift(self, shift):
        dx, dy = shift
        img = smooth_image(128, 128, seed=5)
        mov = shifted(img, dx, dy)
        c = small_config(ts=16, factors=(1, 2), radii=(2, 4), metrics=("L2", "L2"))
        state = init_alignment(jnp.asarray(img), c)
        flow = np.asarray(align(state, jnp.asarray(mov), c))
        inner = flow[2:-2, 2:-2]
        np.testing.assert_allclose(inner[..., 0], dx, atol=0.2)
        np.testing.assert_allclose(inner[..., 1], dy, atol=0.2)

    def test_default_schedule_runs(self):
        img = smooth_image(256, 256, seed=6)
        mov = shifted(img, 1.2, -0.7)
        c = default_config()
        update_snr_config(c, 25)   # Ts = 16, tile_sizes [16,16,16,8]
        state = init_alignment(jnp.asarray(img), c)
        flow = np.asarray(align(state, jnp.asarray(mov), c))
        inner = flow[3:-3, 3:-3]
        np.testing.assert_allclose(inner[..., 0], 1.2, atol=0.2)
        np.testing.assert_allclose(inner[..., 1], -0.7, atol=0.2)


class TestTiledICA:
    def test_matches_gather_ica(self):
        from hmsr_tpu.models.ica import refine_ica, refine_ica_tiled
        import jax.numpy as jnp
        rng = np.random.RandomState(12)
        img = smooth_image(64, 80, seed=12)
        mov = shifted(img, 0.7, -1.3)
        ts = 16
        state = init_ica(jnp.asarray(img), ts)
        flow0 = jnp.asarray((rng.rand(4, 5, 2) * 6 - 3).astype(np.float32))
        a = np.asarray(refine_ica(jnp.asarray(img), state, jnp.asarray(mov),
                                  flow0, ts, n_iter=3))
        b = np.asarray(refine_ica_tiled(jnp.asarray(img), state, jnp.asarray(mov),
                                        flow0, ts, n_iter=3))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_matches_with_extreme_flow(self):
        from hmsr_tpu.models.ica import refine_ica, refine_ica_tiled
        import jax.numpy as jnp
        img = smooth_image(32, 32, seed=13)
        state = init_ica(jnp.asarray(img), 16)
        flow0 = jnp.asarray(np.array([[[500.0, -700.0], [-3.9, 2.2]],
                                      [[0.1, -0.1], [30.0, 30.0]]], np.float32))
        a = np.asarray(refine_ica(jnp.asarray(img), state, jnp.asarray(img),
                                  flow0, 16, n_iter=2))
        b = np.asarray(refine_ica_tiled(jnp.asarray(img), state, jnp.asarray(img),
                                        flow0, 16, n_iter=2))
        np.testing.assert_allclose(a, b, atol=1e-5)


class TestAlignOracle:
    """Full pyramid-descent alignment vs the scalar float64 oracle."""

    @pytest.mark.parametrize("metrics,radii", [
        (("L1", "L2"), (1, 4)),
        (("L2", "L2"), (2, 3)),
    ])
    def test_align_matches_scalar_oracle(self, metrics, radii):
        from oracles import numpy_alignment as oracle
        c = small_config(ts=16, factors=(1, 2), radii=radii, metrics=metrics)
        c.ica.tuning.n_iter = 3
        img = smooth_image(64, 96, seed=21).astype(np.float32)
        mov = shifted(img, -1.7, 2.4)

        state = init_alignment(jnp.asarray(img), c)
        got = np.asarray(align(state, jnp.asarray(mov), c))
        want = oracle.align(img.astype(np.float64), mov.astype(np.float64), c)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


class TestTiledICALargeTiles:
    @pytest.mark.parametrize("ts", [32, 64])
    def test_matches_gather_ica(self, ts):
        """Ts=32/64 (the SNR-adaptive low-light tile sizes): the tiled
        windows equal the gather formulation."""
        from hmsr_tpu.models.ica import refine_ica_tiled
        rng = np.random.RandomState(ts)
        img = smooth_image(2 * ts, 4 * ts, seed=ts)
        mov = shifted(img, 0.6, -1.1)
        state = init_ica(jnp.asarray(img), ts)
        flow0 = jnp.asarray((rng.rand(2, 4, 2) * 8 - 4).astype(np.float32))
        want = np.asarray(refine_ica(jnp.asarray(img), state,
                                     jnp.asarray(mov), flow0, ts, 3))
        got = np.asarray(refine_ica_tiled(jnp.asarray(img), state,
                                          jnp.asarray(mov), flow0, ts, 3))
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("ts", [32, 64])
    def test_extreme_flow_matches_gather(self, ts):
        """Windows pushed partly and wholly off the frame at Ts=32/64."""
        from hmsr_tpu.models.ica import refine_ica_tiled
        img = smooth_image(2 * ts, 2 * ts, seed=ts + 1)
        state = init_ica(jnp.asarray(img), ts)
        flow0 = jnp.asarray(np.array(
            [[[5.0 * ts, -7.0 * ts], [-0.6 * ts, 0.3 * ts]],
             [[0.1, -0.1], [0.9 * ts, 0.9 * ts]]], np.float32))
        want = np.asarray(refine_ica(jnp.asarray(img), state,
                                     jnp.asarray(img), flow0, ts, 2))
        got = np.asarray(refine_ica_tiled(jnp.asarray(img), state,
                                          jnp.asarray(img), flow0, ts, 2))
        np.testing.assert_allclose(got, want, atol=1e-5)
