"""End-to-end pipeline tests on synthetic bursts with exact ground truth."""

import numpy as np
import pytest

import jax.numpy as jnp

from hmsr_tpu.configs import default_config, update_snr_config, sanitize_config
from hmsr_tpu.io.synthetic import make_synthetic_burst, DEFAULT_CFA, area_downsample
from hmsr_tpu.models.pipeline import make_pipeline
from hmsr_tpu.utils.metrics import compute_psnr

WB = [1.0, 1.0, 1.0]
ALPHA, BETA = 1.8e-4, 3.0e-6


def flat_curves():
    """Noise curves for the affine model, evaluated analytically (no MC)."""
    b = np.arange(1001) / 1000.0
    std = np.sqrt(np.maximum(ALPHA * b + BETA, 0)).astype(np.float32)
    # expected |mean1 - mean2| of two 9-px patch means ~ sqrt(2/pi)*sqrt(2*var/9)
    diff = (np.sqrt(2 / np.pi) * np.sqrt(2 * (ALPHA * b + BETA) / 9)).astype(np.float32)
    return jnp.asarray(std), jnp.asarray(diff)


def small_config(scale=2, bayer=True, robustness=True, iso=False):
    c = default_config()
    c.scale = scale
    c.mode = "bayer" if bayer else "grey"
    c.block_matching.tuning.tile_size = 16
    c.block_matching.tuning.factors = [1, 2]
    c.block_matching.tuning.tile_size_factors = [1, 1]
    c.block_matching.tuning.search_radii = [1, 4]
    c.block_matching.tuning.metrics = ["L1", "L2"]
    c.robustness.enabled = robustness
    c.robustness.save_mask = robustness
    c.merging.kernel = "iso" if iso else "steerable"
    update_snr_config(c, 20)
    c.block_matching.tuning.tile_size = 16
    c.block_matching.tuning.tile_sizes = [16, 16]
    c.noise_model.alpha = ALPHA
    c.noise_model.beta = BETA
    c.accumulated_robustness_denoiser.enabled = False
    sanitize_config(c, (128, 128))
    return c


@pytest.fixture(scope="module")
def burst():
    return make_synthetic_burst(128, 128, n_frames=8, alpha=ALPHA, beta=BETA,
                                seed=11)


class TestPipelineE2E:
    def test_x2_bayer_beats_single_frame(self, burst):
        ref, comps, truth, _ = burst
        c = small_config(scale=2)
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, debug = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        img = np.nan_to_num(np.asarray(img))

        crop = 24
        got = img[crop:-crop, crop:-crop]
        want = truth[crop:-crop, crop:-crop]
        psnr = compute_psnr(np.clip(want, 0, 1), np.clip(got, 0, 1))

        # single-frame baseline: nearest-upscaled bilinear-demosaiced ref would
        # be worse; use the noisy mosaic vs truth signal level as the bar.
        truth_lr = area_downsample(truth, 2)
        base = np.repeat(np.repeat(truth_lr, 2, 0), 2, 1)[crop:-crop, crop:-crop]
        base_psnr = compute_psnr(np.clip(want, 0, 1), np.clip(base, 0, 1))

        assert np.isfinite(psnr)
        assert psnr > 30.0, f"merged PSNR too low: {psnr:.2f} dB"
        assert psnr > base_psnr - 1.0, (psnr, base_psnr)

    def test_x1_demosaick_robustness_off(self, burst):
        ref, comps, truth, _ = burst
        c = small_config(scale=1, robustness=False)
        c.robustness.save_mask = False
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        img = np.nan_to_num(np.asarray(img))
        truth_lr = area_downsample(truth, 2)
        crop = 12
        psnr = compute_psnr(np.clip(truth_lr[crop:-crop, crop:-crop], 0, 1),
                            np.clip(img[crop:-crop, crop:-crop], 0, 1))
        assert psnr > 30.0, f"x1 demosaick PSNR too low: {psnr:.2f} dB"

    def test_grey_mode(self):
        ref, comps, truth, _ = make_synthetic_burst(
            128, 128, n_frames=6, alpha=ALPHA, beta=BETA, seed=3, grey=True)
        c = small_config(scale=2, bayer=False, iso=True)
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        img = np.nan_to_num(np.asarray(img))[..., 0]
        crop = 24
        psnr = compute_psnr(np.clip(truth[crop:-crop, crop:-crop], 0, 1),
                            np.clip(img[crop:-crop, crop:-crop], 0, 1))
        assert psnr > 33.0, f"grey x2 PSNR too low: {psnr:.2f} dB"

    def test_debug_outputs(self, burst):
        ref, comps, _, shifts = burst
        c = small_config(scale=2)
        c.debug = True
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, debug = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        assert "flow" in debug and "robustness" in debug
        assert "accumulated_robustness" in debug
        flows = np.asarray(debug["flow"])              # (N-1, ny, nx, 2)
        assert flows.shape[0] == comps.shape[0]
        # recovered flow should match the known shifts (frames vs ref)
        inner = flows[:, 2:-2, 2:-2, :]
        est = inner.mean(axis=(1, 2))
        np.testing.assert_allclose(est, shifts[1:], atol=0.35)
        accr = np.asarray(debug["accumulated_robustness"])
        assert accr.shape == ref.shape
        assert np.all(accr >= 0) and np.all(accr <= comps.shape[0])

    def test_more_frames_reduce_noise(self):
        ref, comps, truth, _ = make_synthetic_burst(
            128, 128, n_frames=10, alpha=3e-3, beta=1e-4, seed=7)
        c = small_config(scale=2)
        c.noise_model.alpha = 3e-3
        c.noise_model.beta = 1e-4
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        b = np.arange(1001) / 1000.0
        std = jnp.asarray(np.sqrt(3e-3 * b + 1e-4).astype(np.float32))
        diff = jnp.asarray((np.sqrt(2 / np.pi * 2 * (3e-3 * b + 1e-4) / 9)).astype(np.float32))

        crop = 24
        want = np.clip(truth[crop:-crop, crop:-crop], 0, 1)

        img2, _ = pipe(jnp.asarray(ref), jnp.asarray(comps[:2]), std, diff)
        img9, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        p2 = compute_psnr(want, np.clip(np.nan_to_num(np.asarray(img2))[crop:-crop, crop:-crop], 0, 1))
        p9 = compute_psnr(want, np.clip(np.nan_to_num(np.asarray(img9))[crop:-crop, crop:-crop], 0, 1))
        assert p9 > p2, (p2, p9)


class TestBaselineConfigs:
    """BASELINE.json benchmark configs #1-#5 exercised end-to-end."""

    def test_x3_accumulated_robustness_merge(self):
        # config #3: x3 scale with full accumulated-robustness weighting
        ref, comps, truth, _ = make_synthetic_burst(
            128, 128, n_frames=6, alpha=ALPHA, beta=BETA, seed=21)
        c = small_config(scale=3)
        c.accumulated_robustness_denoiser.enabled = True
        c.accumulated_robustness_denoiser.merge.enabled = True
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, debug = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        img = np.nan_to_num(np.asarray(img))
        assert img.shape == (384, 384, 3)
        assert np.isfinite(img).all()
        # x3 output vs the x2-grid truth: check brightness statistics only
        assert 0.05 < img[64:-64, 64:-64].mean() < 0.95
        assert "accumulated_robustness" in debug

    def test_bicubic_flow_upscale_mode(self):
        ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=3,
                                                alpha=ALPHA, beta=BETA, seed=22)
        c = small_config(scale=2)
        c.block_matching.tuning.flow_upscale_mode = "bicubic"
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        assert np.isfinite(np.nan_to_num(np.asarray(img))).all()

    def test_bilinear_flow_upscale_mode(self):
        ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=3,
                                                alpha=ALPHA, beta=BETA, seed=23)
        c = small_config(scale=1)
        c.block_matching.tuning.flow_upscale_mode = "bilinear"
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        assert np.isfinite(np.nan_to_num(np.asarray(img))).all()

    def test_grey_consts_arg_bitexact(self):
        """make_pipeline(jit=True)'s grey-consts wrapper (device circulants
        fed as jit ARGUMENTS) must be BIT-identical to the jit=False
        in-trace-expansion fallback on the matmul grey path."""
        ref, comps, _, _ = make_synthetic_burst(64, 128, n_frames=4,
                                                alpha=ALPHA, beta=BETA,
                                                seed=41)
        c = small_config(scale=2)
        sanitize_config(c, (64, 128))
        c.tpu.pipeline = "scan"
        c.tpu.grey_impl = "matmul"     # the consts-bearing grey path
        std, diff = flat_curves()

        import jax
        img_wrap, _ = make_pipeline(c, DEFAULT_CFA, WB)(
            jnp.asarray(ref), jnp.asarray(comps), std, diff)
        img_fall, _ = jax.jit(make_pipeline(c, DEFAULT_CFA, WB, jit=False))(
            jnp.asarray(ref), jnp.asarray(comps), std, diff)
        np.testing.assert_array_equal(np.nan_to_num(np.asarray(img_wrap)),
                                      np.nan_to_num(np.asarray(img_fall)))

    def test_fused_pipeline_matches_scan(self):
        """tpu.pipeline=fused (the integer-scale default: fused-slab merge)
        vs the scan pipeline. Same math; the only sanctioned divergence is
        the per-slab starved-pixel refill (merge_slab.py: the refill sees a
        B-row slab instead of the full image — README "Parity notes"), which
        touches only near-starved pixels at slab/image edges (~1e-2 there).
        Interior pixels must agree to f32 accumulation-order noise."""
        ref, comps, _, _ = make_synthetic_burst(64, 128, n_frames=4,
                                                alpha=ALPHA, beta=BETA,
                                                seed=37)
        c = small_config(scale=2)
        sanitize_config(c, (64, 128))
        std, diff = flat_curves()

        c.tpu.pipeline = "scan"
        img_scan, _ = make_pipeline(c, DEFAULT_CFA, WB)(
            jnp.asarray(ref), jnp.asarray(comps), std, diff)

        c.tpu.pipeline = "fused"
        img_fused, _ = make_pipeline(c, DEFAULT_CFA, WB)(
            jnp.asarray(ref), jnp.asarray(comps), std, diff)

        a, b = np.nan_to_num(np.asarray(img_scan)), \
            np.nan_to_num(np.asarray(img_fused))
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=0)    # refill bound
        crop = 8
        np.testing.assert_allclose(a[crop:-crop, crop:-crop],
                                   b[crop:-crop, crop:-crop],
                                   atol=1e-4, rtol=1e-4)

    def test_hard_threshold_law(self):
        ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=3,
                                                alpha=ALPHA, beta=BETA, seed=24)
        c = small_config(scale=2)
        c.merging.selection_law = "hard_threshold"
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        assert np.isfinite(np.nan_to_num(np.asarray(img))).all()


class TestDecimatingGrey:
    def test_flow_to_raw_grid(self):
        from hmsr_tpu.models.pipeline import flow_to_raw_grid
        flow = jnp.asarray(np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2))
        # raw 70x100 with ts=16 -> 5x7 raw tiles from a 2x3 half-res grid
        out = np.asarray(flow_to_raw_grid(flow, (70, 100), 16))
        assert out.shape == (5, 7, 2)
        # values doubled; raw tile (i, j) reads grey tile (i//2, j//2)
        for i in range(5):
            for j in range(7):
                src = np.asarray(flow)[min(i // 2, 1), min(j // 2, 2)]
                np.testing.assert_allclose(out[i, j], 2.0 * src)

    def test_decimating_pipeline_e2e(self, burst):
        """grey_method=decimating must produce comparable quality to FFT.

        The reference dispatches the method (super_resolution.py:107,145 ->
        utils_image.py:104-115) but hands the half-resolution flow to
        merge/robustness unconverted; we re-tile it to the raw grid (see
        pipeline.flow_to_raw_grid) so the warp is correctly scaled.
        """
        ref, comps, truth, _ = burst
        c = small_config(scale=2)
        c.grey_method = "decimating"
        # half-res grey is 64x64: factors [1,2] with ts 16 still feasible
        sanitize_config(c, (128, 128))
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        img = np.nan_to_num(np.asarray(img))
        crop = 24
        got = img[crop:-crop, crop:-crop]
        want = truth[crop:-crop, crop:-crop]
        psnr = compute_psnr(np.clip(want, 0, 1), np.clip(got, 0, 1))
        assert np.isfinite(psnr)
        assert psnr > 29.0, f"decimating-grey PSNR too low: {psnr:.2f} dB"

    def test_decimating_flow_matches_known_shift(self, burst):
        """The re-tiled debug flow must be in RAW pixels on the raw tile grid
        (values x2 of the half-res estimate) and recover the known shifts."""
        ref, comps, _, shifts = burst
        c = small_config(scale=2)
        c.grey_method = "decimating"
        c.debug = True
        sanitize_config(c, (128, 128))
        pipe = make_pipeline(c, DEFAULT_CFA, WB)
        std, diff = flat_curves()
        _, debug = pipe(jnp.asarray(ref), jnp.asarray(comps), std, diff)
        flow = np.asarray(debug["flow"])          # (N-1, ny, nx, 2)
        assert flow.shape[1:3] == (8, 8)          # raw 128/16 tiles
        est = flow[:, 2:-2, 2:-2, :].mean(axis=(1, 2))
        # half-res alignment is coarser than FFT-grey (the 64x64 grey has
        # only 4x4 tiles): allow 1 raw px. A mis-scaled flow (the reference's
        # unconverted handoff) would miss by ~2x the shift, i.e. up to ~4 px.
        np.testing.assert_allclose(est, shifts[1:], atol=1.0)
