"""Burst-fused merge: all frames accumulated per HR tile in one pass.

The scan-ordered pipeline accumulates each frame into num/den in device
memory (4 x 576 MB of accumulator traffic per frame at 48MP). This module
inverts the loop nest — per HR tile, loop over the burst's frames and
accumulate locally, add the reference-frame contribution, divide, and write
the finished image tile once. Accumulator traffic drops from O(frames x
image) to O(image); per-frame inputs are read as small dynamic windows.

Inputs are the per-frame products of the analysis phase (flows, robustness
maps, covariances), stacked over frames. Mathematically identical to running
``merge`` per frame followed by ``merge_ref`` and the division.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.accumfix import normalize_accum
from ..utils.types import DEFAULT_FLOAT
from .merge_tiled import _cfa_lut, _channel_from_parity, _round_half_even

_BAND_TILE_ROWS = 4


def merge_burst_tiled(comp_stack, flows, covs_stack, r_stack, ref_img,
                      ref_covs, cfa_pattern, config, acc_rob=None):
    """Fused merge of the whole burst; returns the final (c, H*s, W*s) image.

    comp_stack: (F, H, W); flows: (F, ny, nx, 2); covs_stack: (F, 3, gh, gw);
    r_stack: (F, H, W); ref_img/ref_covs: the reference frame and its covs.
    """
    s = int(config.scale)
    assert s == config.scale and s >= 1
    bayer = config.mode == "bayer"
    iso = config.merging.kernel == "iso"
    Ts = int(config.block_matching.tuning.tile_size)
    g = 2 if bayer else 1
    sg = s * g
    cfa = _cfa_lut(cfa_pattern)

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

    F, H, W = comp_stack.shape
    out_h, out_w = round(s * H), round(s * W)
    n_ch = 3 if bayer else 1
    B = Ts * s
    nty = -(-out_h // B)
    ntx = -(-out_w // B)

    WIN = Ts + 4
    CWIN = Ts // g + 4
    PAD = WIN + 1
    CPAD = CWIN + 1
    gh, gw = covs_stack.shape[2], covs_stack.shape[3]

    comp_pad = jnp.pad(comp_stack, ((0, 0), (PAD, PAD), (PAD, PAD)))
    cov_pad = jnp.pad(covs_stack, ((0, 0), (0, 0), (CPAD, CPAD), (CPAD, CPAD)),
                      mode="edge")
    cov_pad = cov_pad.at[:, :, CPAD - 1, :].set(
        2.0 * cov_pad[:, :, CPAD, :] - cov_pad[:, :, CPAD + 1, :])
    cov_pad = cov_pad.at[:, :, :, CPAD - 1].set(
        2.0 * cov_pad[:, :, :, CPAD] - cov_pad[:, :, :, CPAD + 1])
    # Flatten (F, 3, ...) -> (F*3, ...): keeps the BIG spatial dims minor.
    # XLA's layout assignment otherwise tiles the tiny (F, 3) dims to
    # (8, 128) — a 50x memory blowup at 12MP (observed: 38 GB for 708 MB).
    cov_pad = cov_pad.reshape(F * 3, gh + 2 * CPAD, gw + 2 * CPAD)
    r_pad = jnp.pad(r_stack, ((0, 0), (0, nty * Ts - H), (0, ntx * Ts - W)),
                    mode="edge")

    # reference frame: static window machinery (see merge_ref_tiled)
    rr = max(rad_max, 1)
    RWIN = Ts + 2 * rr + 4
    ref_pad = jnp.pad(ref_img, ((PAD + rr, PAD + rr), (PAD + rr, PAD + rr)))
    rcov_pad = jnp.pad(ref_covs, ((0, 0), (CPAD, CPAD), (CPAD, CPAD)),
                       mode="edge")
    rcov_pad = rcov_pad.at[:, CPAD - 1, :].set(
        2.0 * rcov_pad[:, CPAD, :] - rcov_pad[:, CPAD + 1, :])
    rcov_pad = rcov_pad.at[:, :, CPAD - 1].set(
        2.0 * rcov_pad[:, :, CPAD] - rcov_pad[:, :, CPAD + 1])
    if robustness_denoise:
        accr_pad = jnp.pad(acc_rob, ((0, nty * Ts + 2), (0, ntx * Ts + 2)),
                           mode="edge")

    r_loc = jnp.arange(B, dtype=jnp.int32)
    half = jnp.float32(0.5)

    # static per-tile-local staircases for the reference merge (no flow):
    # center(ty*B + r) = ty*Ts + round_half_even(r/s)   (B is a multiple of 2s)
    c_loc_ref = np.array([_round_half_even(int(r) / s) for r in range(B)],
                         np.int32)
    c_loc_ref_j = jnp.asarray(c_loc_ref)
    if bayer:
        period = 2 * s
        m_ref = int(np.floor(-0.5 * s))
    else:
        period = s
        m_ref = 0
    kfloor_loc_ref = np.array([(int(r) + m_ref) // period for r in range(B)],
                              np.int32)
    # ty*B contributes exactly ty*(B//period) whole periods
    assert B % period == 0

    def one_tile(ty, tx):
        # ---------- burst frames ----------
        def frame_contrib(f, carry):
            vals, accs = carry
            fx = flows[f, ty, tx, 0].astype(DEFAULT_FLOAT)
            fy = flows[f, ty, tx, 1].astype(DEFAULT_FLOAT)

            m_y = jnp.floor(half + s * fy).astype(jnp.int32)
            base_y = ty * B + m_y
            Sy = jnp.floor_divide(base_y, s) - 1
            ph_y = base_y - s * (Sy + 1)
            m_x = jnp.floor(half + s * fx).astype(jnp.int32)
            base_x = tx * B + m_x
            Sx = jnp.floor_divide(base_x, s) - 1
            ph_x = base_x - s * (Sx + 1)

            Syc = jnp.clip(Sy, -PAD, H + PAD - WIN)
            Sxc = jnp.clip(Sx, -PAD, W + PAD - WIN)
            ok_tile = (Syc == Sy) & (Sxc == Sx)

            win = jax.lax.dynamic_slice(comp_pad, (f, Syc + PAD, Sxc + PAD),
                                        (1, WIN, WIN))[0]
            up = jnp.repeat(jnp.repeat(win, s, axis=0), s, axis=1)
            U = jax.lax.dynamic_slice(up, (ph_y, ph_x), (B + 2 * s, B + 2 * s))

            center_i = (Sy + 1) + (r_loc + ph_y) // s
            center_j = (Sx + 1) + (r_loc + ph_x) // s

            Rrow = (ty * B + r_loc).astype(DEFAULT_FLOAT)
            Ccol = (tx * B + r_loc).astype(DEFAULT_FLOAT)
            lr_y = (Rrow + half) / s
            lr_x = (Ccol + half) / s
            lr_mov_y = lr_y + fy
            lr_mov_x = lr_x + fx
            inb_center = ((lr_mov_y >= 0) & (lr_mov_y < H))[:, None] & \
                         ((lr_mov_x >= 0) & (lr_mov_x < W))[None, :] & ok_tile

            r_tile = jax.lax.dynamic_slice(r_pad, (f, ty * Ts, tx * Ts),
                                           (1, Ts, Ts))[0]
            local_r = jnp.repeat(jnp.repeat(r_tile, s, axis=0), s, axis=1)
            wr = jnp.where(inb_center, local_r, 0.0)

            if not iso:
                m2_y = jnp.floor(half + s * fy - half * sg).astype(jnp.int32)
                base2_y = ty * B + m2_y
                S2y = jnp.floor_divide(base2_y, sg) - 1
                ph2_y = base2_y - sg * (S2y + 1)
                m2_x = jnp.floor(half + s * fx - half * sg).astype(jnp.int32)
                base2_x = tx * B + m2_x
                S2x = jnp.floor_divide(base2_x, sg) - 1
                ph2_x = base2_x - sg * (S2x + 1)

                S2yc = jnp.clip(S2y, -CPAD, gh + CPAD - CWIN)
                S2xc = jnp.clip(S2x, -CPAD, gw + CPAD - CWIN)
                cwin = jax.lax.dynamic_slice(
                    cov_pad, (f * 3, S2yc + CPAD, S2xc + CPAD),
                    (3, CWIN, CWIN))
                cup = jnp.repeat(jnp.repeat(cwin, sg, axis=1), sg, axis=2)
                CU = jax.lax.dynamic_slice(cup, (0, ph2_y, ph2_x),
                                           (3, B + 2 * sg, B + 2 * sg))

                kmap_y = lr_mov_y / g - half
                kmap_x = lr_mov_x / g - half
                kfloor_y = (S2y + 1) + (r_loc + ph2_y) // sg
                kfloor_x = (S2x + 1) + (r_loc + ph2_x) // sg
                frac_y = (kmap_y - kfloor_y.astype(DEFAULT_FLOAT))[:, None]
                frac_x = (kmap_x - kfloor_x.astype(DEFAULT_FLOAT))[None, :]

                def ctap(dy, dx):
                    return jax.lax.dynamic_slice(
                        CU, (0, sg * (dy + 1), sg * (dx + 1)), (3, B, B))

                c00 = ctap(0, 0)
                c01 = ctap(0, 1)
                c10 = ctap(1, 0)
                c11 = ctap(1, 1)
                top = c00 + frac_x * (c01 - c00)
                bot = c10 + frac_x * (c11 - c10)
                cc = top + frac_y * (bot - top)
                det = cc[0] * cc[2] - cc[1] * cc[1]
                inv_det = 1.0 / det
                ixx = inv_det * cc[2]
                ixy = -inv_det * cc[1]
                iyy = inv_det * cc[0]

            dist_ref_y = (lr_mov_y - half)[:, None]
            dist_ref_x = (lr_mov_x - half)[None, :]

            fvals = [0.0] * n_ch
            faccs = [0.0] * n_ch
            for di in (-1, 0, 1):
                i_g = center_i + di
                inb_i = ((i_g >= 0) & (i_g < H))[:, None]
                pi = (i_g % 2)[:, None]
                dist_y = (i_g.astype(DEFAULT_FLOAT))[:, None] - dist_ref_y
                for dj in (-1, 0, 1):
                    j_g = center_j + dj
                    inb = inb_i & ((j_g >= 0) & (j_g < W))[None, :]
                    pj = (j_g % 2)[None, :]
                    dist_x = (j_g.astype(DEFAULT_FLOAT))[None, :] - dist_ref_x
                    c = U[s * (di + 1):s * (di + 1) + B,
                          s * (dj + 1):s * (dj + 1) + B]
                    if iso:
                        z = 2.0 * (dist_x * dist_x + dist_y * dist_y)
                    else:
                        z = ixx * dist_x * dist_x + 2.0 * ixy * dist_x * dist_y \
                            + iyy * dist_y * dist_y
                    z = jnp.maximum(z, 0.0)
                    w = jnp.exp(-0.5 * z) * wr * inb
                    if bayer:
                        ch = _channel_from_parity(pi, pj, cfa)
                        for k in range(n_ch):
                            mask = (ch == k).astype(DEFAULT_FLOAT)
                            fvals[k] = fvals[k] + w * c * mask
                            faccs[k] = faccs[k] + w * mask
                    else:
                        fvals[0] = fvals[0] + w * c
                        faccs[0] = faccs[0] + w
            return vals + jnp.stack(fvals, 0), accs + jnp.stack(faccs, 0)

        val0 = jnp.zeros((n_ch, B, B), DEFAULT_FLOAT)
        acc0 = jnp.zeros((n_ch, B, B), DEFAULT_FLOAT)
        vals, accs = jax.lax.fori_loop(0, F, frame_contrib, (val0, acc0))

        # ---------- reference frame (zero flow, static staircases) ----------
        pos_y = ((ty * B + r_loc).astype(DEFAULT_FLOAT) / s)[:, None]
        pos_x = ((tx * B + r_loc).astype(DEFAULT_FLOAT) / s)[None, :]
        center_ry = ty * Ts + c_loc_ref_j            # (B,) global
        center_rx = tx * Ts + c_loc_ref_j

        rwin = jax.lax.dynamic_slice(
            ref_pad, (ty * Ts + PAD, tx * Ts + PAD), (RWIN, RWIN))
        # rwin[0,0] corresponds to global (ty*Ts - rr, tx*Ts - rr)

        if not iso:
            # kfloor(ty*B + r) = ty*(B//period) + kfloor_loc_ref[r]
            kbase_y = ty * (B // period)
            kbase_x = tx * (B // period)
            kfloor_y = kbase_y + jnp.asarray(kfloor_loc_ref)
            kfloor_x = kbase_x + jnp.asarray(kfloor_loc_ref)
            # window covering kfloor..kfloor+1 for all r: start at min value
            S2 = kbase_y + int(kfloor_loc_ref.min())
            S2x_ = kbase_x + int(kfloor_loc_ref.min())
            cwin = jax.lax.dynamic_slice(
                rcov_pad, (0, S2 + CPAD, S2x_ + CPAD), (3, CWIN, CWIN))
            if bayer:
                kmap_y = (pos_y - 0.5) / 2.0
                kmap_x = (pos_x - 0.5) / 2.0
            else:
                kmap_y = pos_y
                kmap_x = pos_x
            frac_y = kmap_y - kfloor_y.astype(DEFAULT_FLOAT)[:, None]
            frac_x = kmap_x - kfloor_x.astype(DEFAULT_FLOAT)[None, :]
            # static per-tile-local staircase (same for every tile)
            loc_y_np = kfloor_loc_ref - int(kfloor_loc_ref.min())
            loc_x_np = loc_y_np

            def ctap_ref(dy, dx):
                rows = [cwin[:, int(loc_y_np[r]) + dy] for r in range(B)]
                m = jnp.stack(rows, axis=1)          # (3, B, CWIN)
                cols = [m[:, :, int(loc_x_np[cc_]) + dx] for cc_ in range(B)]
                return jnp.stack(cols, axis=2)       # (3, B, B)

            c00 = ctap_ref(0, 0)
            c01 = ctap_ref(0, 1)
            c10 = ctap_ref(1, 0)
            c11 = ctap_ref(1, 1)
            top = c00 + frac_x * (c01 - c00)
            bot = c10 + frac_x * (c11 - c10)
            cc = top + frac_y * (bot - top)
            det = cc[0] * cc[2] - cc[1] * cc[1]
            okd = jnp.abs(det) > 1e-10
            inv_det = jnp.where(okd, 1.0 / jnp.where(okd, det, 1.0), 1.0)
            ixx = jnp.where(okd, inv_det * cc[2], 1.0)
            ixy = jnp.where(okd, -inv_det * cc[1], 0.0)
            iyy = jnp.where(okd, inv_det * cc[0], 1.0)

        if robustness_denoise:
            # NN lookup min(round(pos), size-1): edge-padded static staircase.
            # Row selection is a static pattern; the tile origin is dynamic,
            # so slice a (Ts+1)-row window first.
            ar_win = jax.lax.dynamic_slice(accr_pad, (ty * Ts, tx * Ts),
                                           (Ts + 1, Ts + 1))
            arm = jnp.stack([ar_win[int(c_loc_ref[r])] for r in range(B)],
                            axis=0)                   # (B, Ts+1)
            lar = jnp.stack(
                [arm[:, int(c_loc_ref[cc_])] for cc_ in range(B)],
                axis=1)                               # (B, B)
            power = jnp.where(lar <= max_frame_count, max_multiplier, 1.0)
            rad = jnp.where(lar <= max_frame_count, rad_max, 1)
        else:
            power = 1.0
            rad = 1

        rvals = [0.0] * n_ch
        raccs = [0.0] * n_ch
        for di in range(-rr, rr + 1):
            ig = center_ry + di
            inb_i = ((ig >= 0) & (ig < H))[:, None]
            pi = (ig % 2)[:, None]
            dist_y = (ig.astype(DEFAULT_FLOAT))[:, None] - pos_y
            # ref window rows: local = c_loc_ref[r] + rr + di (static pattern)
            rows = [rwin[int(c_loc_ref[r]) + rr + di] for r in range(B)]
            rband = jnp.stack(rows, axis=0)          # (B, RWIN)
            for dj in range(-rr, rr + 1):
                jg = center_rx + dj
                inb = inb_i & ((jg >= 0) & (jg < W))[None, :]
                if robustness_denoise:
                    inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
                pj = (jg % 2)[None, :]
                dist_x = (jg.astype(DEFAULT_FLOAT))[None, :] - pos_x
                cols = [rband[:, int(c_loc_ref[cc_]) + rr + dj]
                        for cc_ in range(B)]
                c = jnp.stack(cols, axis=1)          # (B, B)
                if iso:
                    z = jnp.maximum(0.0, 2.0 * (dist_x * dist_x + dist_y * dist_y))
                else:
                    z = ixx * dist_x * dist_x + 2.0 * ixy * dist_x * dist_y \
                        + iyy * dist_y * dist_y
                    z = jnp.maximum(z, 0.0)
                z = z / power
                w = jnp.exp(-0.5 * z) * inb
                if bayer:
                    ch = _channel_from_parity(pi, pj, cfa)
                    for k in range(n_ch):
                        mask = (ch == k).astype(DEFAULT_FLOAT)
                        rvals[k] = rvals[k] + w * c * mask
                        raccs[k] = raccs[k] + w * mask
                else:
                    rvals[0] = rvals[0] + w * c
                    raccs[0] = raccs[0] + w

        rval = jnp.stack(rvals, 0)
        racc = jnp.stack(raccs, 0)
        if robustness_denoise:
            overwrite = (lar < max_frame_count)[None]
            num = jnp.where(overwrite, rval, vals + rval)
            den = jnp.where(overwrite, racc, accs + racc)
        else:
            num = vals + rval
            den = accs + racc
        return normalize_accum(num, den)

    tile_cols = jnp.arange(ntx, dtype=jnp.int32)

    def tile_row(ty):
        out = jax.vmap(lambda tx: one_tile(ty, tx))(tile_cols)  # (ntx, c, B, B)
        return jnp.transpose(out, (1, 2, 0, 3)).reshape(n_ch, B, ntx * B)

    def band(ty0):
        tys = ty0 + jnp.arange(_BAND_TILE_ROWS, dtype=jnp.int32)
        out = jax.vmap(tile_row)(tys)                # (bt, c, B, ntx*B)
        return jnp.transpose(out, (1, 0, 2, 3)).reshape(
            n_ch, _BAND_TILE_ROWS * B, ntx * B)

    n_bands = -(-nty // _BAND_TILE_ROWS)
    starts = jnp.arange(n_bands, dtype=jnp.int32) * _BAND_TILE_ROWS
    img = jax.lax.map(band, starts)                  # (nb, c, bt*B, ntx*B)
    img = jnp.transpose(img, (1, 0, 2, 3)).reshape(n_ch, n_bands *
                                                   _BAND_TILE_ROWS * B, ntx * B)
    return img[:, :out_h, :out_w]