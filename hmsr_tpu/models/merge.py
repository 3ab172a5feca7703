"""Kernel-regression merge accumulation (Alg. 4) and reference-frame merge
(Alg. 11).

Array layout: num/den are channel-first (c, H*s, W*s) and covariances are
component-stacked (3, gh, gw), so every plane is a dense 2-D array.

Rebuild of reference merge.py. The reference dedicates one CUDA thread per
high-resolution output pixel (merge.py:290-434); here the same gather
formulation is evaluated as a vectorized program over the full HR grid —
race-free by construction (each output pixel only reads). This module is
the reference semantics: the fast paths (``merge_tiled``, ``merge_slab``)
are tested against it.

Conventions preserved exactly (see SURVEY.md "hard parts"):
- non-ref: LR position ``(hr + 0.5)/s``; flow tile ``int(lr // tile_size)``;
  robustness fetched nearest at ``min(int(lr), size-1)``; out-of-bounds warped
  centers contribute nothing; covariance sampled at ``lr_mov/2 - 0.5`` on the
  grey grid with *truncation* + signed-fraction bilinear extrapolation and
  unguarded analytic inverse; sample distance measured to ``lr_mov - 0.5``;
  3x3 gather around ``int(lr_mov)``; per-sample CFA channel from pixel parity;
  ``w = exp(-0.5 * max(0, d^T Omega^-1 d))`` (iso: ``exp(-(dx^2+dy^2))``).
- ref: position ``hr/s`` (no half-pixel shift), gather centered at
  ``round(hr/s)``, distances to the unshifted position, epsilon-guarded
  inverse, optional accumulated-robustness single-frame-SR override that
  *overwrites* instead of accumulates (merge.py:223-233).
"""

import numpy as np
import jax.numpy as jnp

from ..ops.linalg2x2 import invert_2x2
from ..utils.types import DEFAULT_FLOAT


def _cfa_channel(i, j, cfa_pattern):
    """Per-pixel CFA channel from pixel parity (static 2x2 pattern)."""
    cfa = np.asarray(cfa_pattern, dtype=np.int32)
    py = i % 2
    px = j % 2
    return jnp.where(py == 0,
                     jnp.where(px == 0, cfa[0, 0], cfa[0, 1]),
                     jnp.where(px == 0, cfa[1, 0], cfa[1, 1]))


def _interp_cov(covs, kmap_i, kmap_j, trunc_floor=True):
    """Clipping bilinear interpolation of the covariance field.

    ``covs``: component-stacked (3, gh, gw) = (xx, xy, yy);
    ``kmap``: fractional grey-grid coordinates.
    Returns components (xx, xy, yy). Fractions follow ``math.modf`` semantics
    (signed, truncation-based) like both reference paths; the lower index is
    truncated then clamped at 0 — the reference's non-ref path truncates
    (merge.py:360-361) and its ref path floors (merge.py:141-142), but since
    coordinates are always >= -1 both give the same clamped index.
    """
    del trunc_floor
    gh, gw = covs.shape[1], covs.shape[2]
    iy = jnp.trunc(kmap_i)
    ix = jnp.trunc(kmap_j)
    frac_y = kmap_i - iy
    frac_x = kmap_j - ix

    fy = jnp.maximum(iy.astype(jnp.int32), 0)
    fx = jnp.maximum(ix.astype(jnp.int32), 0)
    cy = jnp.minimum(fy + 1, gh - 1)
    cx = jnp.minimum(fx + 1, gw - 1)

    def lerp2(a, b, t):
        return a + t * (b - a)

    out = []
    for k in range(3):
        tr = covs[k, fy, fx]
        tl = covs[k, fy, cx]
        br = covs[k, cy, fx]
        bl = covs[k, cy, cx]
        top = lerp2(tr, tl, frac_x)
        bot = lerp2(br, bl, frac_x)
        out.append(lerp2(top, bot, frac_y))
    return out[0], out[1], out[2]


def merge(comp_img, flow, covs, r, num, den, cfa_pattern, config, row_offset=0):
    """Accumulate a non-reference frame into (num, den); returns updated pair.

    ``row_offset`` shifts the HR row coordinates — used when (num, den) is a
    spatially-sharded row block of the full accumulator (parallel pipeline).
    """
    scale = config.scale
    bayer = config.mode == "bayer"
    iso = config.merging.kernel == "iso"
    tile_size = config.block_matching.tuning.tile_size

    lr_h, lr_w = comp_img.shape
    n_ch, hr_h, hr_w = num.shape

    hr_i = (jnp.arange(hr_h) + row_offset).astype(DEFAULT_FLOAT)[:, None]
    hr_j = jnp.arange(hr_w, dtype=DEFAULT_FLOAT)[None, :]
    lr_y = (hr_i + 0.5) / scale
    lr_x = (hr_j + 0.5) / scale

    py = (lr_y // tile_size).astype(jnp.int32)
    px = (lr_x // tile_size).astype(jnp.int32)
    py = jnp.clip(py, 0, flow.shape[0] - 1)
    px = jnp.clip(px, 0, flow.shape[1] - 1)
    flow_x = flow[py, px, 0]
    flow_y = flow[py, px, 1]

    ri = jnp.minimum(lr_y.astype(jnp.int32), lr_h - 1)
    rj = jnp.minimum(lr_x.astype(jnp.int32), lr_w - 1)
    local_r = r[ri, rj]

    lr_mov_x = lr_x + flow_x
    lr_mov_y = lr_y + flow_y
    inbound = ((lr_mov_x >= 0) & (lr_mov_x < lr_w) &
               (lr_mov_y >= 0) & (lr_mov_y < lr_h))

    if not iso:
        if bayer:
            kmap_j = lr_mov_x / 2.0 - 0.5
            kmap_i = lr_mov_y / 2.0 - 0.5
        else:
            kmap_j = lr_mov_x - 0.5
            kmap_i = lr_mov_y - 0.5
        cxx, cxy, cyy = _interp_cov(covs, kmap_i, kmap_j, trunc_floor=True)
        det = cxx * cyy - cxy * cxy          # "invertible by design" (merge.py:389)
        inv_det = 1.0 / det
        ixx = inv_det * cyy
        ixy = -inv_det * cxy
        iyy = inv_det * cxx

    center_j = lr_mov_x.astype(jnp.int32)     # trunc == floor for inbound >= 0
    center_i = lr_mov_y.astype(jnp.int32)
    dist_ref_x = lr_mov_x - 0.5
    dist_ref_y = lr_mov_y - 0.5

    wr = jnp.where(inbound, local_r, 0.0)

    vals = [0.0] * n_ch
    accs = [0.0] * n_ch
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            i = center_i + di
            j = center_j + dj
            inb = (i >= 0) & (i < lr_h) & (j >= 0) & (j < lr_w)
            ic = jnp.clip(i, 0, lr_h - 1)
            jc = jnp.clip(j, 0, lr_w - 1)
            c = comp_img[ic, jc]

            dist_x = j.astype(DEFAULT_FLOAT) - dist_ref_x
            dist_y = i.astype(DEFAULT_FLOAT) - dist_ref_y
            if iso:
                z = 2.0 * (dist_x * dist_x + dist_y * dist_y)
            else:
                z = ixx * dist_x * dist_x + 2.0 * ixy * dist_x * dist_y \
                    + iyy * dist_y * dist_y
            z = jnp.maximum(z, 0.0)
            w = jnp.exp(-0.5 * z) * wr * inb

            if bayer:
                ch = _cfa_channel(i, j, cfa_pattern)
                for k in range(n_ch):
                    mask = (ch == k).astype(DEFAULT_FLOAT)
                    vals[k] = vals[k] + w * c * mask
                    accs[k] = accs[k] + w * mask
            else:
                vals[0] = vals[0] + w * c
                accs[0] = accs[0] + w

    return (num + jnp.stack(vals, axis=0),
            den + jnp.stack(accs, axis=0))


def merge_ref(ref_img, covs, num, den, cfa_pattern, config, acc_rob=None,
              row_offset=0):
    """Accumulate the reference frame (Alg. 11); returns updated (num, den)."""
    scale = config.scale
    bayer = config.mode == "bayer"
    iso = config.merging.kernel == "iso"

    denoise_cfg = config.accumulated_robustness_denoiser
    robustness_denoise = bool(denoise_cfg.get("enabled", False)) and acc_rob is not None
    if robustness_denoise:
        rad_max = int(denoise_cfg.merge.rad_max)
        max_multiplier = float(denoise_cfg.merge.max_multiplier)
        max_frame_count = float(denoise_cfg.merge.max_frame_count)
    else:
        rad_max = 1
        max_multiplier = 1.0
        max_frame_count = 0.0

    in_h, in_w = ref_img.shape
    n_ch, hr_h, hr_w = num.shape

    hr_i = (jnp.arange(hr_h) + row_offset).astype(DEFAULT_FLOAT)[:, None]
    hr_j = jnp.arange(hr_w, dtype=DEFAULT_FLOAT)[None, :]
    pos_y = hr_i / scale
    pos_x = hr_j / scale

    if not iso:
        if bayer:
            grey_y = (pos_y - 0.5) / 2.0
            grey_x = (pos_x - 0.5) / 2.0
        else:
            grey_y = pos_y
            grey_x = pos_x
        cxx, cxy, cyy = _interp_cov(covs, grey_y, grey_x, trunc_floor=False)
        ixx, ixy, _, iyy = invert_2x2(cxx, cxy, cxy, cyy)

    if robustness_denoise:
        ar_i = jnp.minimum(jnp.round(pos_y).astype(jnp.int32), acc_rob.shape[0] - 1)
        ar_j = jnp.minimum(jnp.round(pos_x).astype(jnp.int32), acc_rob.shape[1] - 1)
        local_acc_r = acc_rob[ar_i, ar_j]
        power = jnp.where(local_acc_r <= max_frame_count, max_multiplier, 1.0)
        rad = jnp.where(local_acc_r <= max_frame_count, rad_max, 1)
    else:
        power = 1.0
        rad = 1

    center_y = jnp.round(pos_y).astype(jnp.int32)
    center_x = jnp.round(pos_x).astype(jnp.int32)

    vals = [0.0] * n_ch
    accs = [0.0] * n_ch
    for di in range(-rad_max, rad_max + 1):
        for dj in range(-rad_max, rad_max + 1):
            i = center_y + di
            j = center_x + dj
            inb = (i >= 0) & (i < in_h) & (j >= 0) & (j < in_w)
            if robustness_denoise:
                inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
            ic = jnp.clip(i, 0, in_h - 1)
            jc = jnp.clip(j, 0, in_w - 1)
            c = ref_img[ic, jc]

            dist_x = j.astype(DEFAULT_FLOAT) - pos_x
            dist_y = i.astype(DEFAULT_FLOAT) - pos_y
            if iso:
                z = jnp.maximum(0.0, 2.0 * (dist_x * dist_x + dist_y * dist_y))
            else:
                z = ixx * dist_x * dist_x + 2.0 * ixy * dist_x * dist_y \
                    + iyy * dist_y * dist_y
                z = jnp.maximum(z, 0.0)
            z = z / power
            w = jnp.exp(-0.5 * z) * inb

            if bayer:
                ch = _cfa_channel(i, j, cfa_pattern)
                for k in range(n_ch):
                    mask = (ch == k).astype(DEFAULT_FLOAT)
                    vals[k] = vals[k] + w * c * mask
                    accs[k] = accs[k] + w * mask
            else:
                vals[0] = vals[0] + w * c
                accs[0] = accs[0] + w

    val = jnp.stack(vals, axis=0)
    acc = jnp.stack(accs, axis=0)
    if robustness_denoise:
        overwrite = (local_acc_r < max_frame_count)[None]
        new_num = jnp.where(overwrite, val, num + val)
        new_den = jnp.where(overwrite, acc, den + acc)
        return new_num, new_den
    return num + val, den + acc
