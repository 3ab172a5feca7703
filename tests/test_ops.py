"""Unit tests: ops layer vs pure-NumPy oracles."""

import numpy as np
import pytest

import jax.numpy as jnp

from hmsr_tpu.ops import (
    eigen_2x2, invert_2x2, solve_2x2, quad_mat_prod,
    dogson_quadratic_kernel,
    fft_lowpass_grey, decimate_to_grey,
    gat,
    gaussian_kernel1d, downsample, build_gaussian_pyramid,
    local_stats_3x3, local_min_5x5, box_sum_valid,
    sobel_gradients, halfpixel_gradients,
)
from oracles import numpy_ops as oracle

RNG = np.random.RandomState(0)


class TestLinalg2x2:
    def test_eigen_random_psd(self):
        g = RNG.randn(500, 2)
        m00 = g[:, 0] ** 2
        m11 = g[:, 1] ** 2
        m01 = g[:, 0] * g[:, 1]
        (l1, l2), (e10, e11), (e20, e21) = eigen_2x2(
            jnp.asarray(m00), jnp.asarray(m01), jnp.asarray(m01), jnp.asarray(m11))
        l1, l2 = np.asarray(l1), np.asarray(l2)
        e1 = np.stack([np.asarray(e10), np.asarray(e11)], -1)
        e2 = np.stack([np.asarray(e20), np.asarray(e21)], -1)
        for i in range(500):
            (ol1, ol2), oe1, oe2 = oracle.eig_2x2(m00[i], m01[i], m01[i], m11[i])
            assert np.isclose(l1[i], ol1, atol=1e-5)
            assert np.isclose(l2[i], ol2, atol=1e-5)
            np.testing.assert_allclose(e1[i], oe1, atol=1e-5)
            np.testing.assert_allclose(e2[i], oe2, atol=1e-5)

    def test_eigen_identity_multiple(self):
        (l1, l2), e1, e2 = eigen_2x2(jnp.float32(3.0), jnp.float32(0.0),
                                     jnp.float32(0.0), jnp.float32(3.0))
        assert float(l1) == 3.0 and float(l2) == 3.0
        assert (float(e1[0]), float(e1[1])) == (1.0, 0.0)
        assert (float(e2[0]), float(e2[1])) == (0.0, 1.0)

    def test_eigen_vectors_are_eigenvectors(self):
        g = RNG.randn(200, 3)
        m00, m11 = g[:, 0] ** 2 + 0.1, g[:, 1] ** 2 + 0.1
        m01 = 0.5 * g[:, 2]
        (l1, l2), (e10, e11), (e20, e21) = eigen_2x2(*map(jnp.asarray, (m00, m01, m01, m11)))
        # M e1 ≈ l1 e1
        r0 = m00 * np.asarray(e10) + m01 * np.asarray(e11)
        r1 = m01 * np.asarray(e10) + m11 * np.asarray(e11)
        np.testing.assert_allclose(r0, np.asarray(l1) * np.asarray(e10), atol=1e-3)
        np.testing.assert_allclose(r1, np.asarray(l1) * np.asarray(e11), atol=1e-3)

    def test_invert(self):
        rng = np.random.RandomState(7)
        m = rng.randn(100, 2, 2) + 3 * np.eye(2)
        m = m[np.abs(np.linalg.det(m)) > 0.5]
        i00, i01, i10, i11 = invert_2x2(*[jnp.asarray(m[:, a, b])
                                          for a, b in ((0, 0), (0, 1), (1, 0), (1, 1))])
        inv = np.stack([np.stack([i00, i01], -1), np.stack([i10, i11], -1)], -2)
        np.testing.assert_allclose(inv, np.linalg.inv(m), rtol=1e-4, atol=1e-4)

    def test_invert_singular_falls_back_to_identity(self):
        i00, i01, i10, i11 = invert_2x2(jnp.float32(0), jnp.float32(0),
                                        jnp.float32(0), jnp.float32(0))
        assert (float(i00), float(i01), float(i10), float(i11)) == (1, 0, 0, 1)

    def test_solve(self):
        a = RNG.randn(50, 2, 2) + 2 * np.eye(2)
        b = RNG.randn(50, 2)
        x0, x1 = solve_2x2(a[:, 0, 0], a[:, 0, 1], a[:, 1, 0], a[:, 1, 1],
                           b[:, 0], b[:, 1])
        x = np.stack([x0, x1], -1)
        np.testing.assert_allclose(x, np.linalg.solve(a, b[..., None])[..., 0], atol=1e-5)

    def test_quad_form(self):
        y = quad_mat_prod(2.0, 0.5, 0.5, 3.0, 1.0, 2.0)
        assert np.isclose(float(y), 2 + 2 * 0.5 * 2 + 3 * 4)


class TestDogson:
    def test_matches_oracle(self):
        xs = np.linspace(-2, 2, 201)
        got = np.asarray(dogson_quadratic_kernel(jnp.asarray(xs)))
        want = np.array([oracle.dogson_quadratic(x) for x in xs])
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestGrey:
    @pytest.mark.parametrize("shape", [(16, 16), (18, 22), (17, 19)])
    def test_fft_lowpass(self, shape):
        img = RNG.rand(*shape).astype(np.float32)
        got = np.asarray(fft_lowpass_grey(jnp.asarray(img)))
        want = oracle.fft_lowpass_grey(img)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_decimate(self):
        img = RNG.rand(8, 10).astype(np.float32)
        got = np.asarray(decimate_to_grey(jnp.asarray(img)))
        want = img.reshape(4, 2, 5, 2).mean(axis=(1, 3))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestGAT:
    def test_formula(self):
        img = RNG.rand(8, 8).astype(np.float32)
        alpha, beta = 1.8e-4, 3.19e-6
        got = np.asarray(gat(jnp.asarray(img), alpha, beta))
        want = 2 / alpha * np.sqrt(np.maximum(alpha * img + 3 / 8 * alpha ** 2 + beta, 0))
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestPyramid:
    def test_kernel_matches_scipy(self):
        try:
            from scipy.ndimage._filters import _gaussian_kernel1d
        except ImportError:
            pytest.skip("scipy internals unavailable")
        for factor in (2, 4):
            sigma = 0.5 * factor
            radius = int(4 * sigma + 0.5)
            got = gaussian_kernel1d(sigma, radius)
            want = _gaussian_kernel1d(sigma=sigma, order=0, radius=radius)[::-1]
            np.testing.assert_allclose(got, want, atol=1e-7)

    @pytest.mark.parametrize("factor", [2, 4])
    def test_downsample_matches_oracle(self, factor):
        img = RNG.rand(64, 72).astype(np.float32)
        got = np.asarray(downsample(jnp.asarray(img), factor))
        want = oracle.gaussian_downsample(img.astype(np.float64), factor)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_pyramid_order_coarse_first(self):
        img = jnp.asarray(RNG.rand(128, 128).astype(np.float32))
        pyr = build_gaussian_pyramid(img, [1, 2, 4, 4])
        shapes = [p.shape for p in pyr]
        assert shapes[-1] == (128, 128)          # finest last
        assert shapes[0][0] < shapes[1][0] < shapes[2][0] < shapes[3][0]


class TestStencils:
    def test_local_stats(self):
        img = RNG.rand(3, 9, 11).astype(np.float32)
        gm, gv = local_stats_3x3(jnp.asarray(img))
        om, ov = oracle.local_stats_3x3(img.astype(np.float64))
        np.testing.assert_allclose(np.asarray(gm), om, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gv), ov, atol=1e-5)

    def test_local_min(self):
        img = RNG.rand(12, 9).astype(np.float32)
        got = np.asarray(local_min_5x5(jnp.asarray(img)))
        np.testing.assert_allclose(got, oracle.local_min_5x5(img), atol=1e-7)

    def test_box_sum(self):
        img = RNG.rand(4, 5, 14, 13).astype(np.float32)
        got = np.asarray(box_sum_valid(jnp.asarray(img), 6))
        for a in range(4):
            for b in range(5):
                want = oracle.box_sum_valid(img[a, b].astype(np.float64), 6)
                np.testing.assert_allclose(got[a, b], want, atol=1e-4)


class TestGradients:
    def test_sobel(self):
        img = RNG.rand(10, 12).astype(np.float32)
        gx, gy = sobel_gradients(jnp.asarray(img))
        ox, oy = oracle.sobel_gradients(img)
        np.testing.assert_allclose(np.asarray(gx), ox, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gy), oy, atol=1e-6)

    def test_halfpixel(self):
        img = RNG.rand(9, 8).astype(np.float32)
        got = np.asarray(halfpixel_gradients(jnp.asarray(img)))
        want = oracle.halfpixel_gradients(img.astype(np.float64))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestGreyMatmul:
    @pytest.mark.parametrize("h,w", [(64, 64), (96, 128), (50, 70), (94, 98)])
    def test_matmul_equals_fft(self, h, w):
        """The circulant-matmul low-pass is the same linear operator as the
        FFT path (incl. the reference's asymmetric band edge at sizes not
        divisible by 4, which makes the Im x Im correction term nonzero)."""
        from hmsr_tpu.ops.grey import fft_lowpass_grey, fft_lowpass_grey_matmul
        rng = np.random.RandomState(h * 100 + w)
        img = rng.rand(h, w).astype(np.float32)
        a = np.asarray(fft_lowpass_grey(jnp.asarray(img)))
        b = np.asarray(fft_lowpass_grey_matmul(jnp.asarray(img)))
        np.testing.assert_allclose(a, b, atol=2e-5)

    @pytest.mark.parametrize("h,w", [(64, 96), (128, 128), (90, 132),
                                     (62, 66), (300, 400)])
    def test_ct_equals_fft(self, h, w):
        """The two-stage Cooley-Tukey matmul FFT is the same linear operator
        as the FFT path — including the asymmetric band edge (90/132/62/66
        are not multiples of 4, and 90 = 9x10 puts the band boundary inside
        a k2 block, exercising the partial-block msel path)."""
        from hmsr_tpu.ops.grey import fft_lowpass_grey, fft_lowpass_grey_ct
        rng = np.random.RandomState(h * 100 + w)
        img = rng.rand(h, w).astype(np.float32)
        a = np.asarray(fft_lowpass_grey(jnp.asarray(img)))
        b = np.asarray(fft_lowpass_grey_ct(jnp.asarray(img)))
        np.testing.assert_allclose(a, b, atol=2e-5)

    def test_ct_prime_size_falls_back(self):
        """Prime axis sizes have no usable factor pair — the CT entry point
        must fall back to the circulant matmul and stay correct."""
        from hmsr_tpu.ops.grey import (fft_lowpass_grey, fft_lowpass_grey_ct,
                                       _ct_split)
        assert _ct_split(97) is None
        img = np.random.RandomState(5).rand(97, 64).astype(np.float32)
        a = np.asarray(fft_lowpass_grey(jnp.asarray(img)))
        b = np.asarray(fft_lowpass_grey_ct(jnp.asarray(img)))
        np.testing.assert_allclose(a, b, atol=2e-5)

    def test_ct_impl_dispatch(self):
        """compute_grey_image(impl='ct') routes to the CT path."""
        from hmsr_tpu.ops.grey import compute_grey_image, fft_lowpass_grey_ct
        img = jnp.asarray(np.random.RandomState(6).rand(64, 64)
                          .astype(np.float32))
        a = np.asarray(compute_grey_image(img, "FFT", impl="ct"))
        b = np.asarray(fft_lowpass_grey_ct(img))
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("n", [1, 2, 5, 64, 97])
    def test_circulant_device_bitexact(self, n):
        """The on-device Toeplitz expansion must reproduce the embedded
        (n, n) literal ``k[(i - j) mod n]`` BIT-exactly (it replaced ~400 MB
        of 12MP StableHLO constant payload; values are pure data movement)."""
        from hmsr_tpu.ops.grey import _circulant_device, _circulant_kernel
        mask = (np.random.RandomState(n).rand(n) > 0.4).astype(np.float64)
        k = _circulant_kernel(mask)
        idx = (np.arange(n)[:, None] - np.arange(n)[None, :]) % n
        want = k[idx]
        got = np.asarray(_circulant_device(k))
        assert got.shape == (n, n)
        np.testing.assert_array_equal(got, want)

    def test_consts_arg_bitexact_vs_fallback(self):
        """Feeding grey_matmul_consts through a jit boundary as arguments
        must be BIT-identical to the in-trace expansion fallback (same
        arrays, same dot_generals — only the transport differs)."""
        import jax
        from hmsr_tpu.ops.grey import fft_lowpass_grey_matmul, grey_matmul_consts
        img = np.random.RandomState(3).rand(48, 64).astype(np.float32)
        gc = grey_matmul_consts((48, 64))
        a = np.asarray(jax.jit(fft_lowpass_grey_matmul)(jnp.asarray(img)))
        b = np.asarray(jax.jit(
            lambda x, c: fft_lowpass_grey_matmul(x, consts=c))(
                jnp.asarray(img), gc))
        np.testing.assert_array_equal(a, b)

    def test_grey_consts_for_gating(self):
        """grey_consts_for: None off the matmul path, (a_h, a_w) on it,
        and None (graceful fallback) when called inside a trace."""
        import jax
        from hmsr_tpu.ops.grey import grey_consts_for

        class C(dict):
            pass
        bayer_matmul = {"mode": "bayer", "grey_method": "FFT",
                        "tpu": {"grey_impl": "matmul"}}
        assert grey_consts_for(bayer_matmul, (32, 32)) is not None
        assert grey_consts_for({"mode": "grey"}, (32, 32)) is None
        assert grey_consts_for({"mode": "bayer",
                                "grey_method": "decimating"}, (32, 32)) is None

        seen = []
        def inner(x):
            seen.append(grey_consts_for(bayer_matmul, (32, 32)))
            return x
        jax.jit(inner)(jnp.ones(3))
        assert seen == [None]

    def test_matmul_retrace_no_tracer_leak(self):
        """Regression: the circulant cache once stored trace-local jnp
        constants, so the SECOND jit trace at the same size raised
        UnexpectedTracerError (once seen in a benchmark run). Two fresh
        jits of the same size must both succeed and agree."""
        import jax
        from hmsr_tpu.ops.grey import fft_lowpass_grey_matmul, _CIRC_CACHE
        _CIRC_CACHE.clear()
        img = np.random.RandomState(0).rand(64, 64).astype(np.float32)
        a = np.asarray(jax.jit(fft_lowpass_grey_matmul)(jnp.asarray(img)))
        # a distinct jit wrapper forces a second trace at the same size
        b = np.asarray(jax.jit(lambda x: fft_lowpass_grey_matmul(x) * 1.0)(
            jnp.asarray(img)))
        np.testing.assert_allclose(a, b, atol=1e-6)
        # cached values must be host NumPy, never device/tracer values
        for m in _CIRC_CACHE[(64, 64)]:
            assert type(m) is np.ndarray

    def test_process_twice_matmul_impl(self):
        """process_arrays must be callable twice in one process with the
        explicit matmul grey backend (a trace-cache crash once hid here)."""
        from hmsr_tpu.configs import default_config
        from hmsr_tpu.models.process import process_arrays
        from hmsr_tpu.ops.grey import _CIRC_CACHE
        _CIRC_CACHE.clear()
        rng = np.random.RandomState(1)
        frames = rng.rand(3, 64, 64).astype(np.float32) * 0.5 + 0.25
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
        np.testing.assert_allclose(np.asarray(out1), np.asarray(out2),
                                   atol=1e-6)


class TestMxuDeinterleave:
    """The explicit selection-matmul forms of guide-image / decimate /
    pyramid, pinned to the default slice forms."""

    def test_guide_image_matmul_exact(self):
        from hmsr_tpu.models.robustness import compute_guide_image
        rng = np.random.RandomState(3)
        raw = jnp.asarray(rng.rand(64, 96).astype(np.float32))
        cfa = np.array([[0, 1], [1, 2]])
        wb = [1.9, 1.0, 1.7]
        a = compute_guide_image(raw, cfa, wb, impl="slices")
        b = compute_guide_image(raw, cfa, wb, impl="matmul")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_decimate_matmul_one_ulp(self):
        from hmsr_tpu.ops.grey import decimate_to_grey
        rng = np.random.RandomState(4)
        x = jnp.asarray(rng.rand(62, 96).astype(np.float32))
        a = np.asarray(decimate_to_grey(x, impl="reshape"))
        b = np.asarray(decimate_to_grey(x, impl="matmul"))
        assert a.shape == b.shape
        # different (equally valid) summation order of the 4-tap mean
        np.testing.assert_allclose(a, b, rtol=3e-7, atol=0)

    def test_pyramid_matmul_close(self):
        from hmsr_tpu.ops.pyramid import downsample
        rng = np.random.RandomState(5)
        x = jnp.asarray(rng.rand(300, 400).astype(np.float32))
        for f in (2, 4):
            a = np.asarray(downsample(x, f, impl="slices"))
            b = np.asarray(downsample(x, f, impl="matmul"))
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-7)


class TestLut:
    """The one-hot LUT (explicit option) is bit-exact vs the default gather."""

    @pytest.mark.parametrize("chunk", [None, 1000])
    def test_onehot_matches_gather(self, chunk):
        from hmsr_tpu.ops.lut import lut_lookup
        rng = np.random.RandomState(8)
        tables = [jnp.asarray(rng.rand(1001).astype(np.float32))
                  for _ in range(2)]
        x = jnp.asarray(rng.rand(3, 40, 50).astype(np.float32) * 1.2 - 0.1)
        want = lut_lookup(tables, x)
        got = lut_lookup(tables, x, chunk_elems=chunk, impl="onehot")
        for g, w in zip(got, want):
            assert g.shape == x.shape
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    def test_gather_clips_and_rounds(self):
        from hmsr_tpu.ops.lut import lut_lookup
        t = jnp.arange(1001, dtype=jnp.float32)
        x = jnp.asarray([-0.5, 0.0004, 0.0006, 0.5, 2.0], jnp.float32)
        np.testing.assert_array_equal(np.asarray(lut_lookup(t, x)),
                                      [0, 0, 1, 500, 1000])
