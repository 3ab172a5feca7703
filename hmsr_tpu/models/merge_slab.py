"""Row-slab fused burst merge — the default integer-scale merge.

Same math as :mod:`merge_fused`, which processes small (B, B) tiles. Here
each alignment-tile ROW is processed as one (B, ntx*B)-wide slab, so every
elementwise pass runs over a wide array:

1. the ntx per-tile windows are fetched (vmapped dynamic_slice), phase-
   normalized per tile, and concatenated into a wide buffer;
2. every tap of the 3x3 kernel-regression stencil then becomes a STATIC
   reshape-slice of that buffer ((B+2s, ntx, B+2s) view), so all weight /
   channel / accumulation math runs on full-width slabs;
3. per-tile scalars (flow phases, window origins) are expanded to
   per-column-block vectors with dense reshapes — no gathers anywhere.

The reference frame (no flow, static offsets) is handled image-row-wide
directly. Output is written band-by-band. Mathematically identical to
``merge_fused.merge_burst_tiled`` (tested).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.accumfix import normalize_accum
from ..utils.types import DEFAULT_FLOAT
from .merge_tiled import _cfa_lut, _channel_from_parity, _round_half_even

_BAND_TILE_ROWS = 4


def merge_burst_slab(comp_stack, flows, covs_stack, r_stack, ref_img,
                     ref_covs, cfa_pattern, config, acc_rob=None):
    """Fused merge of the whole burst; returns the final (c, H*s, W*s) image."""
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
    OW = ntx * B

    WIN = Ts + 4
    CWIN = Ts // g + 4
    SEG = B + 2 * s            # phase-normalized comp segment width
    CSEG = B + 2 * sg          # phase-normalized cov segment width
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
    cov_pad = cov_pad.reshape(F * 3, gh + 2 * CPAD, gw + 2 * CPAD)
    r_pad = jnp.pad(r_stack, ((0, 0), (0, nty * Ts - H), (0, ntx * Ts - W)),
                    mode="edge")

    # ---- reference frame constants (static staircases)
    rr = max(rad_max, 1)
    ref_pad = jnp.pad(ref_img, ((rr, rr + nty * Ts - H + 1),
                                (rr, rr + ntx * Ts - W + 1)))
    rcov_pad = jnp.pad(ref_covs, ((0, 0), (CPAD, CPAD), (CPAD, CPAD)),
                       mode="edge")
    rcov_pad = rcov_pad.at[:, CPAD - 1, :].set(
        2.0 * rcov_pad[:, CPAD, :] - rcov_pad[:, CPAD + 1, :])
    rcov_pad = rcov_pad.at[:, :, CPAD - 1].set(
        2.0 * rcov_pad[:, :, CPAD] - rcov_pad[:, :, CPAD + 1])
    if robustness_denoise:
        accr_pad = jnp.pad(acc_rob, ((0, nty * Ts + 2), (0, ntx * Ts + 2)),
                           mode="edge")

    r_loc = jnp.arange(B, dtype=jnp.int32)                    # in-tile offsets
    col_full = jnp.arange(OW, dtype=jnp.int32)
    half = jnp.float32(0.5)
    tile_ids = jnp.arange(ntx, dtype=jnp.int32)

    # reference-merge static staircases (B is a multiple of 2s)
    c_loc_ref = np.array([_round_half_even(int(r) / s) for r in range(B)],
                         np.int32)
    if bayer:
        period = 2 * s
        m_ref = int(np.floor(-0.5 * s))
    else:
        period = s
        m_ref = 0
    kfloor_loc_ref = np.array([(int(r) + m_ref) // period for r in range(B)],
                              np.int32)
    assert B % period == 0

    # x-direction reference staircases over the full output width (static)
    cx_full_np = (np.arange(OW) // B) * Ts + c_loc_ref[np.arange(OW) % B]
    cx_full = jnp.asarray(cx_full_np, jnp.int32)              # (OW,)
    kx_full_np = (np.arange(OW) // B) * (B // period) + \
        kfloor_loc_ref[np.arange(OW) % B]
    kx_full = jnp.asarray(kx_full_np, jnp.int32)

    def expand_cols(v):
        """(ntx,) per-tile value -> (1, OW) per-column vector."""
        return jnp.repeat(v, B)[None, :]

    def win_params(m, base0, n_img, pad, win_sz, rep):
        base = base0 + m
        S = jnp.floor_divide(base, rep) - 1
        ph = base - rep * (S + 1)
        Sc = jnp.clip(S, -pad, n_img + pad - win_sz)
        return S, Sc, ph

    def one_row(ty):
        Rrow = (ty * B + r_loc).astype(DEFAULT_FLOAT)
        lr_y = ((Rrow + half) / s)[:, None]                    # (B, 1)
        lr_x = ((col_full.astype(DEFAULT_FLOAT) + half) / s)[None, :]  # (1, OW)

        # ---------------- burst frames ----------------
        def frame_contrib(f, carry):
            vals, accs = carry
            fx = flows[f, ty, :ntx, 0].astype(DEFAULT_FLOAT)   # (ntx,)
            fy = flows[f, ty, :ntx, 1].astype(DEFAULT_FLOAT)

            m_y = jnp.floor(half + s * fy).astype(jnp.int32)
            Sy, Syc, ph_y = win_params(m_y, ty * B, H, PAD, WIN, s)
            m_x = jnp.floor(half + s * fx).astype(jnp.int32)
            Sx, Sxc, ph_x = win_params(m_x, tile_ids * B, W, PAD, WIN, s)
            ok = (Syc == Sy) & (Sxc == Sx)

            # windows -> phase-normalized -> wide slab (SEG per tile)
            def fetch(syc, sxc, py, px):
                w = jax.lax.dynamic_slice(comp_pad, (f, syc + PAD, sxc + PAD),
                                          (1, WIN, WIN))[0]
                u = jnp.repeat(jnp.repeat(w, s, axis=0), s, axis=1)
                return jax.lax.dynamic_slice(u, (py, px), (SEG, SEG))

            U = jax.vmap(fetch)(Syc, Sxc, ph_y, ph_x)          # (ntx, SEG, SEG)
            Ucat = jnp.transpose(U, (1, 0, 2))                 # (SEG, ntx, SEG)

            # geometry (per-tile -> per-column expansions)
            center_i = (Sy + 1)[None, :] + \
                (r_loc[:, None] + ph_y[None, :]) // s          # (B, ntx)
            center_i = jnp.repeat(center_i, B, axis=1)         # (B, OW)
            cj_tile = (Sx + 1)[:, None] + \
                (r_loc[None, :] + ph_x[:, None]) // s          # (ntx, B)
            center_j = cj_tile.reshape(1, OW)

            fy_c = expand_cols(fy)
            fx_c = expand_cols(fx)
            lr_mov_y = lr_y + fy_c                             # (B, OW)
            lr_mov_x = lr_x + fx_c                             # (1, OW)
            inb_center = ((lr_mov_y >= 0) & (lr_mov_y < H) &
                          (lr_mov_x >= 0) & (lr_mov_x < W) &
                          expand_cols(ok))

            r_band = jax.lax.dynamic_slice(
                r_pad, (f, ty * Ts, 0), (1, Ts, ntx * Ts))[0]
            local_r = jnp.repeat(jnp.repeat(r_band, s, axis=0), s, axis=1)
            wr = jnp.where(inb_center, local_r, 0.0)

            if not iso:
                m2_y = jnp.floor(half + s * fy - half * sg).astype(jnp.int32)
                S2y, S2yc, ph2_y = win_params(m2_y, ty * B, gh, CPAD, CWIN, sg)
                m2_x = jnp.floor(half + s * fx - half * sg).astype(jnp.int32)
                S2x, S2xc, ph2_x = win_params(m2_x, tile_ids * B, gw, CPAD,
                                              CWIN, sg)

                def cfetch(syc, sxc, py, px):
                    w = jax.lax.dynamic_slice(
                        cov_pad, (f * 3, syc + CPAD, sxc + CPAD),
                        (3, CWIN, CWIN))
                    u = jnp.repeat(jnp.repeat(w, sg, axis=1), sg, axis=2)
                    return jax.lax.dynamic_slice(u, (0, py, px),
                                                 (3, CSEG, CSEG))

                CU = jax.vmap(cfetch)(S2yc, S2xc, ph2_y, ph2_x)  # (ntx,3,CSEG,CSEG)
                CUcat = jnp.transpose(CU, (1, 2, 0, 3))          # (3,CSEG,ntx,CSEG)

                kfloor_y = (S2y + 1)[None, :] + \
                    (r_loc[:, None] + ph2_y[None, :]) // sg      # (B, ntx)
                kfloor_y = jnp.repeat(kfloor_y, B, axis=1)       # (B, OW)
                kfx_tile = (S2x + 1)[:, None] + \
                    (r_loc[None, :] + ph2_x[:, None]) // sg      # (ntx, B)
                kfloor_x = kfx_tile.reshape(1, OW)

                kmap_y = lr_mov_y / g - half
                kmap_x = lr_mov_x / g - half
                frac_y = kmap_y - kfloor_y.astype(DEFAULT_FLOAT)
                frac_x = kmap_x - kfloor_x.astype(DEFAULT_FLOAT)

                def ctap(dy, dx):
                    v = CUcat[:, sg * (dy + 1):sg * (dy + 1) + B, :,
                              sg * (dx + 1):sg * (dx + 1) + B]
                    return v.reshape(3, B, OW)

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

            dist_ref_y = lr_mov_y - half
            dist_ref_x = lr_mov_x - half

            fvals = [0.0] * n_ch
            faccs = [0.0] * n_ch
            for di in (-1, 0, 1):
                i_g = center_i + di                             # (B, OW)
                inb_i = (i_g >= 0) & (i_g < H)
                pi = i_g % 2
                dist_y = i_g.astype(DEFAULT_FLOAT) - dist_ref_y
                for dj in (-1, 0, 1):
                    j_g = center_j + dj
                    inb = inb_i & (j_g >= 0) & (j_g < W)
                    pj = j_g % 2
                    dist_x = j_g.astype(DEFAULT_FLOAT) - dist_ref_x
                    c = Ucat[s * (di + 1):s * (di + 1) + B, :,
                             s * (dj + 1):s * (dj + 1) + B].reshape(B, OW)
                    if iso:
                        z = 2.0 * (dist_x * dist_x + dist_y * dist_y)
                    else:
                        z = ixx * dist_x * dist_x \
                            + 2.0 * ixy * dist_x * dist_y \
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

        val0 = jnp.zeros((n_ch, B, OW), DEFAULT_FLOAT)
        vals, accs = jax.lax.fori_loop(0, F, frame_contrib, (val0, val0))

        # ---------------- reference frame (static, row-wide) ----------------
        pos_y = (Rrow / s)[:, None]
        pos_x = (col_full.astype(DEFAULT_FLOAT) / s)[None, :]
        center_ry = ty * Ts + c_loc_ref                        # (B,) numpy+int
        center_ry_j = jnp.asarray(c_loc_ref) + ty * Ts

        # ref rows band: global rows [ty*Ts - rr, ty*Ts + Ts + rr]
        rband_rows = jax.lax.dynamic_slice(
            ref_pad, (ty * Ts, 0), (Ts + 2 * rr + 1, ref_pad.shape[1]))
        # rband_rows[k] = global row ty*Ts - rr + k

        if not iso:
            kbase_y = ty * (B // period)
            kfloor_y = kbase_y + jnp.asarray(kfloor_loc_ref)   # (B,)
            if bayer:
                kmap_y = (pos_y - 0.5) / 2.0
                kmap_x = (pos_x - 0.5) / 2.0
            else:
                kmap_y = pos_y
                kmap_x = pos_x
            frac_y = kmap_y - kfloor_y.astype(DEFAULT_FLOAT)[:, None]
            frac_x = kmap_x - kx_full.astype(DEFAULT_FLOAT)[None, :]

            # cov rows band: kfloor range [kbase+min, kbase+max+1]
            kmin = int(kfloor_loc_ref.min())
            kspan = int(kfloor_loc_ref.max()) - kmin + 2
            crows = jax.lax.dynamic_slice(
                rcov_pad, (0, kbase_y + kmin + CPAD, 0),
                (3, kspan, rcov_pad.shape[2]))
            # crows[:, k] = cov row kbase + kmin + k

            loc_y_np = kfloor_loc_ref - kmin                   # (B,) static
            kx_min = int(kx_full_np.min())
            loc_x_np = kx_full_np - kx_min                     # (OW,) static

            def ctap_ref(dy, dx):
                rows = crows[:, loc_y_np + dy]                 # (3, B, width)
                return rows[:, :, CPAD + kx_min + loc_x_np + dx]
            # static numpy fancy indexing on jnp arrays lowers to gathers of
            # rows/cols with STATIC indices -> XLA turns them into slices or
            # a single small gather; acceptable once per row-band.

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
            ar_band = jax.lax.dynamic_slice(
                accr_pad, (ty * Ts, 0), (Ts + 1, accr_pad.shape[1]))
            lar = ar_band[c_loc_ref][:, np.minimum(cx_full_np,
                                                   accr_pad.shape[1] - 1)]
            power = jnp.where(lar <= max_frame_count, max_multiplier, 1.0)
            rad = jnp.where(lar <= max_frame_count, rad_max, 1)
        else:
            power = 1.0
            rad = 1

        rvals = [0.0] * n_ch
        raccs = [0.0] * n_ch
        for di in range(-rr, rr + 1):
            ig = center_ry_j + di                               # (B,)
            inb_i = ((ig >= 0) & (ig < H))[:, None]
            pi = (ig % 2)[:, None]
            dist_y = (ig.astype(DEFAULT_FLOAT))[:, None] - pos_y
            rsel = rband_rows[c_loc_ref + rr + di]              # (B, width)
            for dj in range(-rr, rr + 1):
                jg = cx_full + dj
                inb = inb_i & ((jg >= 0) & (jg < W))[None, :]
                if robustness_denoise:
                    inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
                pj = (jg % 2)[None, :]
                dist_x = (jg.astype(DEFAULT_FLOAT))[None, :] - pos_x
                c = rsel[:, cx_full_np + rr + dj]               # (B, OW)
                if iso:
                    z = jnp.maximum(0.0, 2.0 * (dist_x * dist_x
                                                + dist_y * dist_y))
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
        # per-slab normalization: the starved-pixel refill sees only this
        # B-row slab (bounded-memory by design — this path exists to avoid
        # materializing full num/den). At starved pixels near slab edges the
        # refill mixes a truncated neighborhood, so outputs there can differ
        # ~1e-2 from the scan/sharded paths' full-context refill (both are
        # convex mixes of valid neighbors; see accumfix.normalize_accum).
        return normalize_accum(num, den)                        # (c, B, OW)

    def band(ty0):
        tys = ty0 + jnp.arange(_BAND_TILE_ROWS, dtype=jnp.int32)
        out = jax.vmap(one_row)(tys)                 # (bt, c, B, OW)
        return jnp.transpose(out, (1, 0, 2, 3)).reshape(
            n_ch, _BAND_TILE_ROWS * B, OW)

    n_bands = -(-nty // _BAND_TILE_ROWS)
    starts = jnp.arange(n_bands, dtype=jnp.int32) * _BAND_TILE_ROWS
    img = jax.lax.map(band, starts)
    img = jnp.transpose(img, (1, 0, 2, 3)).reshape(n_ch, -1, OW)
    return img[:, :out_h, :out_w]