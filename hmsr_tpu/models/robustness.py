"""Noise-model-aware robustness estimation (Algs. 6-9).

Rebuild of reference robustness.py as fused elementwise/stencil jnp — no
custom kernels (the reference launches 8 CUDA kernels per frame; XLA fuses
the whole chain into a few elementwise passes).

Stage chain (Alg. 6, reference robustness.py:79-170):
guide image -> 3x3 local stats -> Dodgson upscale/warp to the raw grid ->
channel distance -> noise-model correction (sigma/d LUTs) -> flow
discontinuity term S -> threshold -> 5x5 local min.

Parity notes:
- the reference marks out-of-bounds warped statistics by writing ``1/0``
  (+inf) and lets the arithmetic poison downstream values so R ~ 0
  (robustness.py:387-390 "infinity will imply R = 0"). Infs/NaNs are
  hostile to vectorized min-reductions, so we carry an explicit validity
  mask instead and force R = 0 where it is unset — same intent, defined
  numerics (interior pixels are bit-identical).
- the reference kernel hardcodes the upscale factor to 2 even in grey mode
  (robustness.py:359-360 overrides the passed ``upscale``); we use the true
  factor (2 for Bayer, 1 for grey) — the IPOL-intended behavior.
- LUT indices ``round(1000 * brightness)`` are clipped to the curve domain
  [0, 1000] (the reference reads out of bounds for invalid brightness).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.dogson import dogson_quadratic_kernel
from ..ops.lut import lut_lookup
from ..ops.stencils import local_stats_3x3, local_min_5x5
from ..utils.types import DEFAULT_FLOAT


class RefStats(NamedTuple):
    """Reference-frame statistics, upscaled to the raw grid.

    The noise-model terms depend only on the reference frame, so the LUT
    lookups and the sigma^2 reduction are precomputed once per burst (the
    reference re-evaluates them per frame, robustness.py:504-533 — identical
    values).
    """
    means: jnp.ndarray     # (C, H, W)
    d_t: jnp.ndarray       # (C, H, W) — diff-curve value at the local mean
    sigma_sq: jnp.ndarray  # (H, W) — sum_c max(local var, sigma_t^2)
    valid: jnp.ndarray     # (H, W) bool — False where the warp left the grid


def compute_guide_image(raw, cfa_pattern, white_balance, impl="slices"):
    """Bayer quad -> half-res RGB with white balance undone (Alg. 7).

    ``cfa_pattern``: static 2x2 numpy int array; ``white_balance``: length-3+
    gains (indexed by channel). Returns (3, H/2, W/2).

    ``impl``: "slices" (default) extracts the four quad phases with strided
    slices; "matmul" extracts the column phases with 0/1 selection matmuls
    (bit-exact: the selection is exact in bf16 and the raw data rides an
    exact bf16x3 split).
    """
    h, w = raw.shape
    cfa = np.asarray(cfa_pattern, dtype=np.int64)

    if impl == "matmul":
        from ..ops.grey import _sel_dot_cols
        h2, w2 = h // 2, w // 2
        # column phases via selection matmuls; row phases via slices
        cols = [_sel_dot_cols(raw[:2 * h2], w, w2, j) for j in (0, 1)]
        phases = {(i, j): cols[j][i::2] for i in (0, 1) for j in (0, 1)}
    else:
        quads = raw[: (h // 2) * 2, : (w // 2) * 2].reshape(
            h // 2, 2, w // 2, 2)
        phases = {(i, j): quads[:, i, :, j] for i in (0, 1) for j in (0, 1)}

    chans = [None, None, None]
    green = 0.0
    for i in range(2):
        for j in range(2):
            c = int(cfa[i, j])
            x = phases[(i, j)] / white_balance[c]
            if c == 1:
                green = green + x
            else:
                chans[c] = x
    chans[1] = green / 2.0
    return jnp.stack(chans, axis=0).astype(DEFAULT_FLOAT)


def upscale_warp_stats(stats, upscale, tile_size=None, flow=None):
    """Dodgson-biquadratic upscale (and optional warp) of guide-grid stats.

    ``stats``: (C, h, w) on the guide grid. Returns ``(hr_stats, valid)`` with
    ``hr_stats``: (C, h*upscale, w*upscale) and ``valid`` False where the
    source coordinate fell outside the guide grid (the reference writes +inf
    there).
    """
    c, lr_h, lr_w = stats.shape
    hr_h, hr_w = lr_h * upscale, lr_w * upscale

    y = jnp.arange(hr_h, dtype=DEFAULT_FLOAT)[:, None]
    x = jnp.arange(hr_w, dtype=DEFAULT_FLOAT)[None, :]

    if flow is not None:
        ty = (jnp.arange(hr_h) // tile_size).astype(jnp.int32)
        tx = (jnp.arange(hr_w) // tile_size).astype(jnp.int32)
        flow_x = flow[ty[:, None], tx[None, :], 0]
        flow_y = flow[ty[:, None], tx[None, :], 1]
    else:
        flow_x = 0.0
        flow_y = 0.0

    lr_y = (y + flow_y + 0.5) / upscale - 0.5
    lr_x = (x + flow_x + 0.5) / upscale - 0.5

    valid = (lr_y >= 0) & (lr_y < lr_h) & (lr_x >= 0) & (lr_x < lr_w)

    cy = jnp.round(lr_y).astype(jnp.int32)
    cx = jnp.round(lr_x).astype(jnp.int32)

    acc = jnp.zeros((c, hr_h, hr_w), DEFAULT_FLOAT)
    w_acc = jnp.zeros((hr_h, hr_w), DEFAULT_FLOAT)
    for i in (-1, 0, 1):
        yy = jnp.clip(cy + i, 0, lr_h - 1)
        wy = dogson_quadratic_kernel(yy.astype(DEFAULT_FLOAT) - lr_y)
        for j in (-1, 0, 1):
            xx = jnp.clip(cx + j, 0, lr_w - 1)
            wx = dogson_quadratic_kernel(xx.astype(DEFAULT_FLOAT) - lr_x)
            wgt = wy * wx
            acc = acc + stats[:, yy, xx] * wgt[None]
            w_acc = w_acc + wgt

    return acc / w_acc[None], valid


def init_robustness(ref_raw, cfa_pattern, white_balance, noise_curves, config):
    """Reference-frame statistics + precomputed noise-model terms."""
    if not config.robustness.enabled:
        return None

    bayer = config.mode == "bayer"
    if bayer:
        guide = compute_guide_image(ref_raw, cfa_pattern, white_balance)
        upscale = 2
    else:
        guide = ref_raw[None]
        upscale = 1

    means, stds = local_stats_3x3(guide)
    if _use_tiled_warp(config):
        Ts = config.block_matching.tuning.tile_size
        out_shape = (guide.shape[1] * upscale, guide.shape[2] * upscale)
        zero_flow = jnp.zeros((-(-out_shape[0] // Ts), -(-out_shape[1] // Ts), 2),
                              DEFAULT_FLOAT)
        hr_means, valid_m = upscale_warp_stats_tiled(means, upscale, Ts,
                                                     zero_flow, out_shape)
        hr_stds, _ = upscale_warp_stats_tiled(stds, upscale, Ts, zero_flow,
                                              out_shape)
    else:
        hr_means, valid_m = upscale_warp_stats(means, upscale)
        hr_stds, _ = upscale_warp_stats(stds, upscale)

    std_curve, diff_curve = noise_curves
    sigma_t, d_t = lut_lookup([std_curve, diff_curve], hr_means)
    sigma_sq = jnp.sum(jnp.maximum(hr_stds, sigma_t * sigma_t), axis=0)
    return RefStats(means=hr_means, d_t=d_t, sigma_sq=sigma_sq, valid=valid_m)


def _use_tiled_warp(config):
    return config.get("tpu", {}).get("robustness_impl", "auto") != "gather"



def apply_noise_model(d_p, ref_means, ref_stds, std_curve, diff_curve):
    """sigma^2 and d^2 maps corrected by the calibrated noise curves."""
    idx = jnp.clip(jnp.round(1000.0 * ref_means), 0, std_curve.shape[0] - 1
                   ).astype(jnp.int32)
    d_t = diff_curve[idx]
    sigma_t = std_curve[idx]

    sigma_sq = jnp.sum(jnp.maximum(ref_stds, sigma_t * sigma_t), axis=0)
    d_p_sq = d_p * d_p
    shrink = d_p_sq / (d_p_sq + d_t * d_t)
    d_sq = jnp.sum(d_p_sq * shrink * shrink, axis=0)
    return d_sq, sigma_sq


def compute_s(flow, m_th, s1, s2):
    """Flow-discontinuity map: s1 where the 3x3 flow range exceeds Mt, else s2."""
    fx = flow[..., 0]
    fy = flow[..., 1]

    def rng3(a):
        p = jnp.pad(a, 1, mode="edge")
        hi = None
        lo = None
        h, w = a.shape
        for i in range(3):
            for j in range(3):
                v = p[i:i + h, j:j + w]
                hi = v if hi is None else jnp.maximum(hi, v)
                lo = v if lo is None else jnp.minimum(lo, v)
        return hi - lo

    d0 = rng3(fx)
    d1 = rng3(fy)
    return jnp.where(d0 * d0 + d1 * d1 > m_th * m_th, s1, s2).astype(DEFAULT_FLOAT)


def compute_robustness(comp_img, ref_stats, flow, cfa_pattern, white_balance,
                       config):
    """Robustness map r of the compared frame, at raw resolution (Alg. 6)."""
    if not config.robustness.enabled:
        return jnp.ones(comp_img.shape, DEFAULT_FLOAT)

    bayer = config.mode == "bayer"
    tile_size = config.block_matching.tuning.tile_size
    tun = config.robustness.tuning

    if bayer:
        guide = compute_guide_image(comp_img, cfa_pattern, white_balance)
        upscale = 2
    else:
        guide = comp_img[None]
        upscale = 1

    comp_means, _ = local_stats_3x3(guide)
    # profiling knob: truncate the chain after k sub-stages; the output
    # stays shape-correct but carries only the computed prefix (1 =
    # guide+stats, 2 = +warp, 3 = +noise/threshold chain w/o the 5x5 local
    # min, else full). Guarded: truncation silently
    # corrupts output, so it refuses to run unless the profiling harness
    # has set HMSR_DEBUG_TRUNC=1.
    trunc = int(config.get("tpu", {}).get("rob_trunc", 0))
    if trunc:
        import os
        if os.environ.get("HMSR_DEBUG_TRUNC") != "1":
            raise ValueError(
                "tpu.rob_trunc is a profiling-only knob that truncates the "
                "robustness chain (output becomes meaningless). Unset it, or "
                "set HMSR_DEBUG_TRUNC=1 if you are bisecting performance.")
    if trunc == 1:
        return jnp.full(comp_img.shape, jnp.sum(comp_means[:, ::7, ::11]),
                        DEFAULT_FLOAT)
    if _use_tiled_warp(config):
        out_shape = (guide.shape[1] * upscale, guide.shape[2] * upscale)
        comp_means, comp_valid = upscale_warp_stats_tiled(
            comp_means, upscale, tile_size, flow, out_shape)
    else:
        comp_means, comp_valid = upscale_warp_stats(comp_means, upscale,
                                                    tile_size=tile_size,
                                                    flow=flow)
    if trunc == 2:
        return jnp.full(comp_img.shape,
                        jnp.sum(comp_means[:, ::7, ::11]) +
                        jnp.sum(comp_valid[::7, ::11]), DEFAULT_FLOAT)

    d_p = jnp.abs(ref_stats.means - comp_means)
    d_t = ref_stats.d_t
    d_p_sq = d_p * d_p
    shrink = d_p_sq / (d_p_sq + d_t * d_t)
    d_sq = jnp.sum(d_p_sq * shrink * shrink, axis=0)
    sigma_sq = ref_stats.sigma_sq

    S = compute_s(flow, tun.Mt, tun.s1, tun.s2)

    h, w = d_sq.shape
    # dense tile->pixel broadcast (avoids a 12MP gather)
    s_map = jnp.repeat(jnp.repeat(S, tile_size, axis=0), tile_size, axis=1)[:h, :w]

    R = jnp.clip(s_map * jnp.exp(-d_sq / sigma_sq) - tun.t, 0.0, 1.0)
    R = jnp.where(ref_stats.valid & comp_valid, R, 0.0)
    if trunc == 3:
        return R
    return local_min_5x5(R)


# ---------------------------------------------------------------------------
# Tiled (gather-free) upscale-warp — the default path.
# ---------------------------------------------------------------------------

def upscale_warp_stats_tiled(stats, upscale, tile_size, flow, out_shape,
                             band_tile_rows=8):
    """Gather-free version of :func:`upscale_warp_stats`.

    Exploits per-tile-constant flow exactly like the tiled merge: the
    rounding staircase ``center(Y) = round((Y + fy + 0.5)/u - 0.5) =
    (Y + floor(fy + 0.5)) // u`` turns the 3x3 Dodgson stencil into static
    shifts of a u-times-repeated dynamic window. Tap values use edge-padded
    statistics (the reference clamps tap indices, robustness.py:403-407);
    tap weights use the clamped coordinates, matching the reference.

    Rounding note: exact round-half-even ties (possible only for flows that
    make ``(Y + fy + 0.5)/u`` an exact half-integer) resolve half-up here;
    float flows from ICA make this a measure-zero event.

    ``out_shape``: (H, W) raw grid. Returns ``(hr_stats (C,H,W), valid (H,W))``.
    """
    c, lh, lw = stats.shape
    H, W = out_shape
    Ts = tile_size
    u = upscale
    nty = -(-H // Ts)
    ntx = -(-W // Ts)

    WIN = Ts // u + 4
    PAD = WIN + 1
    stats_pad = jnp.pad(stats, ((0, 0), (PAD, PAD), (PAD, PAD)), mode="edge")

    y_loc = jnp.arange(Ts, dtype=jnp.int32)
    half = jnp.float32(0.5)

    def one_tile(ty, tx):
        fx = flow[ty, tx, 0].astype(DEFAULT_FLOAT)
        fy = flow[ty, tx, 1].astype(DEFAULT_FLOAT)

        m_y = jnp.floor(fy + half).astype(jnp.int32)
        base_y = ty * Ts + m_y
        Sy = jnp.floor_divide(base_y, u) - 1
        ph_y = base_y - u * (Sy + 1)
        m_x = jnp.floor(fx + half).astype(jnp.int32)
        base_x = tx * Ts + m_x
        Sx = jnp.floor_divide(base_x, u) - 1
        ph_x = base_x - u * (Sx + 1)

        Syc = jnp.clip(Sy, -PAD, lh + PAD - WIN)
        Sxc = jnp.clip(Sx, -PAD, lw + PAD - WIN)
        ok_tile = (Syc == Sy) & (Sxc == Sx)

        win = jax.lax.dynamic_slice(stats_pad, (0, Syc + PAD, Sxc + PAD),
                                    (c, WIN, WIN))
        up = jnp.repeat(jnp.repeat(win, u, axis=1), u, axis=2)
        U = jax.lax.dynamic_slice(up, (0, ph_y, ph_x),
                                  (c, Ts + 2 * u, Ts + 2 * u))

        center_y = (Sy + 1) + (y_loc + ph_y) // u       # (Ts,) global LR rows
        center_x = (Sx + 1) + (y_loc + ph_x) // u

        Yg = (ty * Ts + y_loc).astype(DEFAULT_FLOAT)
        Xg = (tx * Ts + y_loc).astype(DEFAULT_FLOAT)
        lr_y = (Yg + fy + half) / u - half
        lr_x = (Xg + fx + half) / u - half
        valid = ((lr_y >= 0) & (lr_y < lh))[:, None] & \
                ((lr_x >= 0) & (lr_x < lw))[None, :] & ok_tile

        acc = jnp.zeros((c, Ts, Ts), DEFAULT_FLOAT)
        w_acc = jnp.zeros((Ts, Ts), DEFAULT_FLOAT)
        for i in (-1, 0, 1):
            yc = jnp.clip(center_y + i, 0, lh - 1).astype(DEFAULT_FLOAT)
            wy = dogson_quadratic_kernel(yc - lr_y)[:, None]
            for j in (-1, 0, 1):
                xc = jnp.clip(center_x + j, 0, lw - 1).astype(DEFAULT_FLOAT)
                wgt = wy * dogson_quadratic_kernel(xc - lr_x)[None, :]
                v = U[:, u * (i + 1):u * (i + 1) + Ts,
                      u * (j + 1):u * (j + 1) + Ts]
                acc = acc + v * wgt[None]
                w_acc = w_acc + wgt
        return acc / w_acc[None], valid

    tile_cols = jnp.arange(ntx, dtype=jnp.int32)

    def tile_row(ty):
        v, m = jax.vmap(lambda tx: one_tile(ty, tx))(tile_cols)
        v = jnp.transpose(v, (1, 2, 0, 3)).reshape(c, Ts, ntx * Ts)
        m = jnp.transpose(m, (1, 0, 2)).reshape(Ts, ntx * Ts)
        return v, m

    def band(ty0):
        tys = ty0 + jnp.arange(band_tile_rows, dtype=jnp.int32)
        v, m = jax.vmap(tile_row)(tys)
        return (jnp.transpose(v, (1, 0, 2, 3)).reshape(
                    c, band_tile_rows * Ts, ntx * Ts),
                m.reshape(band_tile_rows * Ts, ntx * Ts))

    n_bands = -(-nty // band_tile_rows)
    starts = jnp.arange(n_bands, dtype=jnp.int32) * band_tile_rows
    v, m = jax.lax.map(band, starts)
    v = jnp.transpose(v, (1, 0, 2, 3)).reshape(c, n_bands * band_tile_rows * Ts,
                                               ntx * Ts)
    m = m.reshape(n_bands * band_tile_rows * Ts, ntx * Ts)
    return v[:, :H, :W], m[:H, :W]
