"""Tile-restructured merge accumulation — the integer-scale fast path.

Same math as :mod:`hmsr_tpu.models.merge` (Alg. 4 / Alg. 11), restructured
around the key observation that the optical flow is constant within each
alignment tile: every "random" gather of the per-output-pixel formulation is
actually a **dense window at a per-tile dynamic offset**. Each HR tile
(Ts*s x Ts*s output block) reads:

- a (Ts+4)^2 window of the comp frame at offset ``tile_origin + int(flow)``,
- a (Ts/g+4)^2 window of the covariance grid (g = 2 for Bayer),
- a static Ts^2 window of the robustness map,

and everything else is closed-form elementwise math. The per-row staircase
``center(R) = floor((R + 0.5)/s + flow) = (R + m) // s`` (m = floor(0.5 +
s*flow), exact for integer s) turns the 3x3 neighborhood gather into **static
shifts of an s-times-repeated window slice** — no gather ops at all, just
dynamic_slice + repeat + shifted slices, which XLA fuses into dense
elementwise passes over each tile.

Requires an integer scale s >= 1 (the pipeline falls back to the exact
gather path otherwise); output matches the gather path bit-for-bit up to fp
reassociation, including the negative-fraction covariance extrapolation at
the frame border (handled by a linear-extrapolation pad row/column).

Memory: processed in bands of tile rows (lax.map), so peak temporaries are
O(band) not O(48MP).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.types import DEFAULT_FLOAT

_BAND_TILE_ROWS = 8      # tile rows per lax.map band


def _cfa_lut(cfa_pattern):
    cfa = np.asarray(cfa_pattern, dtype=np.int32)
    return cfa


def _channel_from_parity(pi, pj, cfa):
    return jnp.where(pi == 0,
                     jnp.where(pj == 0, cfa[0, 0], cfa[0, 1]),
                     jnp.where(pj == 0, cfa[1, 0], cfa[1, 1]))


def merge_tiled(comp_img, flow, covs, r, num, den, cfa_pattern, config,
                row_offset=0):
    """Drop-in replacement for ``merge`` (non-ref accumulation, Alg. 4).

    ``row_offset`` (python int or traced scalar) shifts the HR row origin:
    (num, den) then hold global HR rows [row_offset, row_offset + out_h) —
    the space-sharded accumulator layout of parallel/sharded.py. Tiles are
    indexed on the GLOBAL grid; a shard boundary may straddle a tile, so the
    local accumulator gets a one-tile guard pad top and bottom and tile
    writes land at (traced) dynamic offsets.
    """
    s = int(config.scale)
    assert s == config.scale and s >= 1
    bayer = config.mode == "bayer"
    iso = config.merging.kernel == "iso"
    Ts = int(config.block_matching.tuning.tile_size)
    g = 2 if bayer else 1
    cfa = _cfa_lut(cfa_pattern)

    H, W = comp_img.shape
    n_ch, out_h, out_w = num.shape
    B = Ts * s
    sharded = not (isinstance(row_offset, int) and row_offset == 0)
    if sharded:
        row_offset = jnp.asarray(row_offset, jnp.int32)
        t_off = row_offset // B
        off = row_offset % B
        # worst-case local tile-row count: the block plus one straddled tile
        nty = -(-out_h // B) + 1
    else:
        t_off = 0
        off = 0
        nty = -(-out_h // B)
    ntx = -(-out_w // B)
    nty_all = flow.shape[0]
    assert flow.shape[1] >= ntx, (flow.shape, nty, ntx)
    if not sharded:
        assert nty_all >= nty, (flow.shape, nty)

    WIN = Ts + 4                    # comp window side
    CWIN = Ts // g + 4              # cov window side
    PAD = WIN + 1
    gh, gw = covs.shape[1], covs.shape[2]

    comp_pad = jnp.pad(comp_img, ((PAD, PAD), (PAD, PAD)))
    # Edge padding implements the reference's index clamping on the cov grid.
    # Index -1 additionally holds the LINEAR EXTRAPOLATION of the first cell:
    # for warped positions in the first half-pixel the reference evaluates the
    # cell-[0,1] bilinear patch at a negative modf fraction (merge.py:357-361);
    # interpolating our cell [-1,0] with extrapolated corners reproduces that
    # patch exactly (a bilinear patch is determined by its corners).
    CPAD = CWIN + 1
    cov_pad = jnp.pad(covs, ((0, 0), (CPAD, CPAD), (CPAD, CPAD)), mode="edge")
    cov_pad = cov_pad.at[:, CPAD - 1, :].set(
        2.0 * cov_pad[:, CPAD, :] - cov_pad[:, CPAD + 1, :])
    cov_pad = cov_pad.at[:, :, CPAD - 1].set(
        2.0 * cov_pad[:, :, CPAD] - cov_pad[:, :, CPAD + 1])
    # robustness, padded to the (global) tile grid with edge values
    r_pad = jnp.pad(r, ((0, max(nty_all, -(-H // Ts)) * Ts - H),
                        (0, ntx * Ts - W)), mode="edge")

    r_loc = jnp.arange(B, dtype=jnp.int32)          # in-tile HR offsets
    half = jnp.float32(0.5)

    def one_tile(ty, tx):
        fx = flow[ty, tx, 0].astype(DEFAULT_FLOAT)
        fy = flow[ty, tx, 1].astype(DEFAULT_FLOAT)

        # ---- comp window bookkeeping (rows) ----
        m_y = jnp.floor(half + s * fy).astype(jnp.int32)
        base_y = ty * B + m_y
        Sy = jnp.floor_divide(base_y, s) - 1        # first LR row of window
        ph_y = base_y - s * (Sy + 1)                # == base_y mod s
        m_x = jnp.floor(half + s * fx).astype(jnp.int32)
        base_x = tx * B + m_x
        Sx = jnp.floor_divide(base_x, s) - 1
        ph_x = base_x - s * (Sx + 1)

        Syc = jnp.clip(Sy, -PAD, H + PAD - WIN)
        Sxc = jnp.clip(Sx, -PAD, W + PAD - WIN)
        ok_tile = (Syc == Sy) & (Sxc == Sx)         # else fully out of frame

        win = jax.lax.dynamic_slice(comp_pad, (Syc + PAD, Sxc + PAD), (WIN, WIN))
        up = jnp.repeat(jnp.repeat(win, s, axis=0), s, axis=1)
        U = jax.lax.dynamic_slice(up, (ph_y, ph_x), (B + 2 * s, B + 2 * s))

        # global center indices (unclamped — used for masks and parities)
        center_i = (Sy + 1) + (r_loc + ph_y) // s       # (B,)
        center_j = (Sx + 1) + (r_loc + ph_x) // s

        # ---- positions and per-pixel weights ----
        Rrow = (ty * B + r_loc).astype(DEFAULT_FLOAT)
        Ccol = (tx * B + r_loc).astype(DEFAULT_FLOAT)
        lr_y = (Rrow + half) / s                        # (B,)
        lr_x = (Ccol + half) / s
        lr_mov_y = lr_y + fy
        lr_mov_x = lr_x + fx
        inb_center = ((lr_mov_y >= 0) & (lr_mov_y < H))[:, None] & \
                     ((lr_mov_x >= 0) & (lr_mov_x < W))[None, :]
        inb_center = inb_center & ok_tile

        # robustness: NN at (min(int(lr_y), H-1), ...) == tile-static window
        r_tile = jax.lax.dynamic_slice(r_pad, (ty * Ts, tx * Ts), (Ts, Ts))
        local_r = jnp.repeat(jnp.repeat(r_tile, s, axis=0), s, axis=1)

        # ---- covariance interpolation ----
        if not iso:
            sg = s * g
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

            cwin = jax.lax.dynamic_slice(cov_pad, (0, S2yc + CPAD, S2xc + CPAD),
                                         (3, CWIN, CWIN))
            cup = jnp.repeat(jnp.repeat(cwin, sg, axis=1), sg, axis=2)
            CU = jax.lax.dynamic_slice(cup, (0, ph2_y, ph2_x),
                                       (3, B + 2 * sg, B + 2 * sg))

            kmap_y = lr_mov_y / g - half                 # (B,)
            kmap_x = lr_mov_x / g - half
            kfloor_y = (S2y + 1) + (r_loc + ph2_y) // sg
            kfloor_x = (S2x + 1) + (r_loc + ph2_x) // sg
            frac_y = (kmap_y - kfloor_y.astype(DEFAULT_FLOAT))[:, None]
            frac_x = (kmap_x - kfloor_x.astype(DEFAULT_FLOAT))[None, :]

            def ctap(dy, dx):
                # window row kfloor_local + dy with kfloor_local = (r+ph2)//sg + 1
                return CU[:, sg * (dy + 1):sg * (dy + 1) + B,
                          sg * (dx + 1):sg * (dx + 1) + B]

            c00 = ctap(0, 0)
            c01 = ctap(0, 1)
            c10 = ctap(1, 0)
            c11 = ctap(1, 1)
            top = c00 + frac_x * (c01 - c00)
            bot = c10 + frac_x * (c11 - c10)
            cc = top + frac_y * (bot - top)              # (3, B, B)
            det = cc[0] * cc[2] - cc[1] * cc[1]
            inv_det = 1.0 / det
            ixx = inv_det * cc[2]
            ixy = -inv_det * cc[1]
            iyy = inv_det * cc[0]

        # ---- 3x3 accumulation ----
        dist_ref_y = (lr_mov_y - half)[:, None]
        dist_ref_x = (lr_mov_x - half)[None, :]
        wr = jnp.where(inb_center, local_r, 0.0)

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in (-1, 0, 1):
            i_g = center_i + di                          # (B,) global LR rows
            inb_i = (i_g >= 0) & (i_g < H)
            pi = (i_g % 2)[:, None]
            dist_y = (i_g.astype(DEFAULT_FLOAT))[:, None] - dist_ref_y
            for dj in (-1, 0, 1):
                j_g = center_j + dj
                inb = inb_i[:, None] & ((j_g >= 0) & (j_g < W))[None, :]
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
                        vals[k] = vals[k] + w * c * mask
                        accs[k] = accs[k] + w * mask
                else:
                    vals[0] = vals[0] + w * c
                    accs[0] = accs[0] + w

        return jnp.stack(vals, 0), jnp.stack(accs, 0)   # (n_ch, B, B)

    tile_cols = jnp.arange(ntx, dtype=jnp.int32)

    def tile_row(ty):
        v, a = jax.vmap(lambda tx: one_tile(t_off + ty, tx))(tile_cols)
        # (ntx, c, B, B) -> (c, B, ntx*B)
        v = jnp.transpose(v, (1, 2, 0, 3)).reshape(n_ch, B, ntx * B)
        a = jnp.transpose(a, (1, 2, 0, 3)).reshape(n_ch, B, ntx * B)
        return v, a

    def band(ty0):
        tys = ty0 + jnp.arange(_BAND_TILE_ROWS, dtype=jnp.int32)
        v, a = jax.vmap(tile_row)(tys)          # (bt, c, B, ntx*B)
        return (jnp.transpose(v, (1, 0, 2, 3)).reshape(
                    n_ch, _BAND_TILE_ROWS * B, ntx * B),
                jnp.transpose(a, (1, 0, 2, 3)).reshape(
                    n_ch, _BAND_TILE_ROWS * B, ntx * B))

    # Accumulate band deltas directly into the carried num/den with
    # read-modify-write slices — never materializes full-frame delta arrays
    # (at 48MP those alone would be >1 GB of temporaries per frame).
    BH = _BAND_TILE_ROWS * B
    n_bands = -(-nty // _BAND_TILE_ROWS)
    pad_w = ntx * B
    # guard rows: a straddled boundary tile writes up to B rows above/below
    # the local block (sharded); band writes land at traced offsets.
    top = B if sharded else 0
    pad_h = top + n_bands * BH + (B if sharded else 0)
    pad_h = max(pad_h, top + out_h)
    num_p = jnp.pad(num, ((0, 0), (top, pad_h - top - out_h), (0, pad_w - out_w)))
    den_p = jnp.pad(den, ((0, 0), (top, pad_h - top - out_h), (0, pad_w - out_w)))

    def band_body(bi, carry):
        num_p, den_p = carry
        v, a = band(bi * _BAND_TILE_ROWS)
        y0 = top + bi * BH - off
        cur_n = jax.lax.dynamic_slice(num_p, (0, y0, 0), (n_ch, BH, pad_w))
        cur_d = jax.lax.dynamic_slice(den_p, (0, y0, 0), (n_ch, BH, pad_w))
        num_p = jax.lax.dynamic_update_slice(num_p, cur_n + v, (0, y0, 0))
        den_p = jax.lax.dynamic_update_slice(den_p, cur_d + a, (0, y0, 0))
        return num_p, den_p

    num_p, den_p = jax.lax.fori_loop(0, n_bands, band_body, (num_p, den_p))
    return num_p[:, top:top + out_h, :out_w], den_p[:, top:top + out_h, :out_w]


# ---------------------------------------------------------------------------
# Reference-frame merge (Alg. 11), gather-free.
# ---------------------------------------------------------------------------

def _round_half_even(x):
    return int(np.round(x))


def _resample_nn(arr, s, n_out, taps, axis, pad_mode):
    """out_t[R] = arr[round_half_even(R/s) + t] along ``axis`` for each tap t.

    The half-even rounding staircase has exact period 2s, so each output is a
    phase interleave of 2s static strided slices — no gather. ``pad_mode``
    'zero' leaves out-of-range taps at 0 (they are masked downstream), 'edge'
    replicates (index-clamping semantics). Returns a dict tap -> array.
    """
    P = 2 * s
    n = arr.shape[axis]
    nq = -(-n_out // P)
    c_p = [_round_half_even(p / s) for p in range(P)]

    lo = -min(taps) - min(c_p)
    hi = max(c_p) + 2 * (nq - 1) + max(taps) + 1 - n
    lo = max(lo, 0)
    hi = max(hi, 0)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (lo, hi)
    arr_pad = jnp.pad(arr, pad, mode="edge" if pad_mode == "edge" else "constant")

    def take(start):
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(start + lo, start + lo + 2 * nq, 2)
        return arr_pad[tuple(idx)]

    out = {}
    for t in taps:
        phases = [take(c_p[p] + t) for p in range(P)]
        stacked = jnp.stack(phases, axis=axis + 1)
        shape = list(arr.shape)
        shape[axis] = nq * P
        merged = stacked.reshape(shape[:axis] + [nq * P] + shape[axis + 1:])
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(0, n_out)
        out[t] = merged[tuple(idx)]
    return out


def _floor_resample(arr, period, m, n_out, taps, axis):
    """out_t[R] = arr[(R + m)//period + t] with linear-extrapolation padding
    at index -1 and edge padding beyond (covariance clamping semantics)."""
    n = arr.shape[axis]
    nq = -(-n_out // period)
    e_p = [(p + m) // period for p in range(period)]

    lo = max(0, -(min(e_p) + min(taps)))
    hi = max(0, max(e_p) + nq - 1 + max(taps) + 1 - n)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (lo, hi)
    arr_pad = jnp.pad(arr, pad, mode="edge")
    if lo > 0:
        # linear extrapolation at global index -1 (see merge_tiled docstring)
        sl = [slice(None)] * arr.ndim

        def row(i):
            s2 = list(sl)
            s2[axis] = i
            return tuple(s2)
        arr_pad = arr_pad.at[row(lo - 1)].set(
            2.0 * arr_pad[row(lo)] - arr_pad[row(lo + 1)])

    def take(start):
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(start + lo, start + lo + nq)
        return arr_pad[tuple(idx)]

    out = {}
    for t in taps:
        phases = [take(e_p[p] + t) for p in range(period)]
        stacked = jnp.stack(phases, axis=axis + 1)
        shape = list(arr.shape)
        merged = stacked.reshape(shape[:axis] + [nq * period] + shape[axis + 1:])
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(0, n_out)
        out[t] = merged[tuple(idx)]
    return out


def merge_ref_tiled(ref_img, covs, num, den, cfa_pattern, config, acc_rob=None,
                    band_rows=512):
    """Gather-free reference-frame accumulation; exact ``merge_ref`` semantics.

    With zero flow every coordinate staircase is static, so all neighborhood
    reads become phase-interleaved strided slices (pure layout ops + dense
    math). Row resampling is done once at full width; the column resampling
    and accumulation run in static row bands accumulated straight into
    num/den (bounded temporaries at 48MP outputs). Requires integer scale.
    """
    s = int(config.scale)
    assert s == config.scale and s >= 1
    bayer = config.mode == "bayer"
    iso = config.merging.kernel == "iso"
    cfa = _cfa_lut(cfa_pattern)
    g = 2 if bayer else 1

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

    H, W = ref_img.shape
    n_ch, out_h, out_w = num.shape

    taps = list(range(-rad_max, rad_max + 1))
    # full-width row resampling (cheap; the column pass is banded below)
    rows = _resample_nn(ref_img, s, out_h, taps, axis=0, pad_mode="zero")

    # global tap coordinates (static numpy staircases)
    P = 2 * s
    c_p = np.array([_round_half_even(p / s) for p in range(P)], np.int64)
    nq = -(-out_h // P)
    center_y_np = (np.tile(c_p, nq) + np.repeat(np.arange(nq) * 2, P))[:out_h]
    nqx = -(-out_w // P)
    center_x = jnp.asarray(
        (np.tile(c_p, nqx) + np.repeat(np.arange(nqx) * 2, P))[:out_w], jnp.int32)

    pos_x = (jnp.arange(out_w, dtype=DEFAULT_FLOAT) / s)[None, :]

    if not iso:
        if bayer:
            period = 2 * s
            m = int(np.floor(-0.5 * s))
        else:
            period = s
            m = 0
        rowc = _floor_resample(covs, period, m, out_h, [0, 1], axis=1)
        kfloor_x_np = (np.arange(out_w) + m) // period
        kmap_x = ((pos_x - 0.5) / 2.0) if bayer else pos_x
        frac_x = kmap_x - jnp.asarray(kfloor_x_np, DEFAULT_FLOAT)[None, :]
        kfloor_y_np = (np.arange(out_h) + m) // period

    if robustness_denoise:
        ar_rows = _resample_nn(acc_rob, s, out_h, [0], axis=0, pad_mode="edge")[0]

    jg_x = center_x[None, :]
    inb_x = ((jg_x >= 0) & (jg_x < W))
    pj = jg_x % 2
    dist_x_taps = {dj: (center_x + dj).astype(DEFAULT_FLOAT)[None, :] - pos_x
                   for dj in taps}
    inb_x_taps = {dj: ((center_x + dj) >= 0)[None, :] & ((center_x + dj) < W)[None, :]
                  for dj in taps}
    pj_taps = {dj: ((center_x + dj) % 2)[None, :] for dj in taps}

    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        bh = y1 - y0
        pos_y = (jnp.arange(y0, y1, dtype=DEFAULT_FLOAT) / s)[:, None]
        cy = jnp.asarray(center_y_np[y0:y1], jnp.int32)

        # column resampling of this band's row taps
        ref_taps = {di: _resample_nn(rows[di][y0:y1], s, out_w, taps, axis=1,
                                     pad_mode="zero") for di in taps}

        if not iso:
            ctaps = {dy: _floor_resample(rowc[dy][:, y0:y1], period, m, out_w,
                                         [0, 1], axis=2) for dy in (0, 1)}
            kmap_y = ((pos_y - 0.5) / 2.0) if bayer else pos_y
            frac_y = kmap_y - jnp.asarray(kfloor_y_np[y0:y1],
                                          DEFAULT_FLOAT)[:, None]
            c00 = ctaps[0][0]
            c01 = ctaps[0][1]
            c10 = ctaps[1][0]
            c11 = ctaps[1][1]
            top = c00 + frac_x * (c01 - c00)
            bot = c10 + frac_x * (c11 - c10)
            cc = top + frac_y * (bot - top)
            det = cc[0] * cc[2] - cc[1] * cc[1]
            ok = jnp.abs(det) > 1e-10
            inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 1.0)
            ixx = jnp.where(ok, inv_det * cc[2], 1.0)
            ixy = jnp.where(ok, -inv_det * cc[1], 0.0)
            iyy = jnp.where(ok, inv_det * cc[0], 1.0)

        if robustness_denoise:
            local_acc_r = _resample_nn(ar_rows[y0:y1], s, out_w, [0], axis=1,
                                       pad_mode="edge")[0]
            power = jnp.where(local_acc_r <= max_frame_count, max_multiplier, 1.0)
            rad = jnp.where(local_acc_r <= max_frame_count, rad_max, 1)
        else:
            power = 1.0
            rad = 1

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in taps:
            i_g = cy + di
            inb_i = ((i_g >= 0) & (i_g < H))[:, None]
            pi = (i_g % 2)[:, None]
            dist_y = (i_g.astype(DEFAULT_FLOAT))[:, None] - pos_y
            for dj in taps:
                inb = inb_i & inb_x_taps[dj]
                if robustness_denoise:
                    inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
                dist_x = dist_x_taps[dj]
                c = ref_taps[di][dj]

                if iso:
                    z = jnp.maximum(0.0, 2.0 * (dist_x * dist_x + dist_y * dist_y))
                else:
                    z = ixx * dist_x * dist_x + 2.0 * ixy * dist_x * dist_y \
                        + iyy * dist_y * dist_y
                    z = jnp.maximum(z, 0.0)
                z = z / power
                w = jnp.exp(-0.5 * z) * inb

                if bayer:
                    ch = _channel_from_parity(pi, pj_taps[dj], cfa)
                    for k in range(n_ch):
                        mask = (ch == k).astype(DEFAULT_FLOAT)
                        vals[k] = vals[k] + w * c * mask
                        accs[k] = accs[k] + w * mask
                else:
                    vals[0] = vals[0] + w * c
                    accs[0] = accs[0] + w

        val = jnp.stack(vals, 0)
        acc = jnp.stack(accs, 0)
        if robustness_denoise:
            overwrite = (local_acc_r < max_frame_count)[None]
            num = num.at[:, y0:y1].set(
                jnp.where(overwrite, val, num[:, y0:y1] + val))
            den = den.at[:, y0:y1].set(
                jnp.where(overwrite, acc, den[:, y0:y1] + acc))
        else:
            num = num.at[:, y0:y1].add(val)
            den = den.at[:, y0:y1].add(acc)

    return num, den
