"""Tiled upscale-warp must match the gather implementation exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

from hmsr_tpu.models.robustness import upscale_warp_stats, upscale_warp_stats_tiled


@pytest.mark.parametrize("upscale", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_warped_matches_gather(upscale, seed):
    rng = np.random.RandomState(seed)
    lh, lw = 24, 32
    H, W = lh * upscale, lw * upscale
    Ts = 16
    stats = rng.rand(3, lh, lw).astype(np.float32)
    ny, nx = -(-H // Ts), -(-W // Ts)
    flow = ((rng.rand(ny, nx, 2) * 2 - 1) * 6).astype(np.float32)

    want, wvalid = upscale_warp_stats(jnp.asarray(stats), upscale,
                                      tile_size=Ts, flow=jnp.asarray(flow))
    got, gvalid = upscale_warp_stats_tiled(jnp.asarray(stats), upscale, Ts,
                                           jnp.asarray(flow), (H, W),
                                           band_tile_rows=2)
    np.testing.assert_array_equal(np.asarray(gvalid), np.asarray(wvalid))
    m = np.asarray(wvalid)
    np.testing.assert_allclose(np.asarray(got)[:, m], np.asarray(want)[:, m],
                               atol=1e-5)


def test_ref_path_matches():
    rng = np.random.RandomState(3)
    lh, lw = 16, 20
    u = 2
    H, W = lh * u, lw * u
    Ts = 16
    stats = rng.rand(3, lh, lw).astype(np.float32)
    zero_flow = jnp.zeros((-(-H // Ts), -(-W // Ts), 2), jnp.float32)

    want, wvalid = upscale_warp_stats(jnp.asarray(stats), u)
    got, gvalid = upscale_warp_stats_tiled(jnp.asarray(stats), u, Ts,
                                           zero_flow, (H, W), band_tile_rows=1)
    np.testing.assert_array_equal(np.asarray(gvalid), np.asarray(wvalid))
    m = np.asarray(wvalid)
    np.testing.assert_allclose(np.asarray(got)[:, m], np.asarray(want)[:, m],
                               atol=1e-5)


def test_huge_flow_all_invalid():
    stats = jnp.ones((1, 8, 8))
    flow = jnp.full((1, 1, 2), 1e6, jnp.float32)
    got, valid = upscale_warp_stats_tiled(stats, 2, 16, flow, (16, 16))
    assert not bool(np.asarray(valid).any())


# ---------------------------------------------------------------------------
# low-light tile sizes (Ts=32/64) vs the gather implementation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upscale", [1, 2])
@pytest.mark.parametrize("Ts", [32, 64])
def test_large_tiles_match_gather(Ts, upscale):
    rng = np.random.RandomState(Ts + upscale)
    lh, lw = Ts * 3 // 2, Ts * 2
    H, W = lh * upscale, lw * upscale
    stats = rng.rand(3, lh, lw).astype(np.float32)
    ny, nx = -(-H // Ts), -(-W // Ts)
    flow = ((rng.rand(ny, nx, 2) * 2 - 1) * 6).astype(np.float32)

    want, wvalid = upscale_warp_stats(jnp.asarray(stats), upscale,
                                      tile_size=Ts, flow=jnp.asarray(flow))
    got, gvalid = upscale_warp_stats_tiled(jnp.asarray(stats), upscale, Ts,
                                           jnp.asarray(flow), (H, W),
                                           band_tile_rows=1)
    np.testing.assert_array_equal(np.asarray(gvalid), np.asarray(wvalid))
    m = np.asarray(wvalid)
    np.testing.assert_allclose(np.asarray(got)[:, m], np.asarray(want)[:, m],
                               atol=1e-5)
