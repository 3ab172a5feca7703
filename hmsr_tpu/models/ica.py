"""ICA / inverse-compositional Lucas-Kanade sub-pixel flow refinement.

Rebuild of the reference's per-tile-size CUDA kernels (reference
ICA.py:36-482) as one vectorized Gauss-Newton loop:

- init: 1-D [-1, 0, 1] gradients with 'same' zero padding (ICA.py:20-21) and
  a per-tile 2x2 Hessian ``[[sum gx^2, sum gx gy], [., sum gy^2]]``
  (ICA.py:36-76), computed as a reshape-reduce.
- iterate (``n_iter`` Gauss-Newton steps, ICA.py:141-188): bilinearly warp the
  moving image at the current per-tile flow, ``gradt = warp - ref``, reduce
  ``B = -sum grad * gradt`` over each tile, solve the 2x2 system analytically,
  update the flow. Tiles whose Hessian has ``|det| < 1e-10`` keep their input
  flow (the reference kernel early-exits, ICA.py:124-126).

Numerics preserved:
- integer/fraction split uses *truncation toward zero* (the reference uses
  ``int(flow)`` + ``math.modf``), so negative flows produce negative
  fractional parts and the same extrapolating bilinear weights;
- out-of-bounds bilinear taps read 0 (ICA.py:240-243). The reference's
  tile-8 kernel clamps coordinates instead (ICA.py:152-156) and its tile-64
  kernel has an off-by-one row shift (ICA.py:437-445); both are unified here
  on the zero-fill semantics of the 16/32 kernels — the intended math.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.gradients import sobel_gradients
from ..utils.types import DEFAULT_FLOAT


class IcaRefState(NamedTuple):
    gradx: jnp.ndarray     # (lvl_h, lvl_w)
    grady: jnp.ndarray
    hessian: jnp.ndarray   # (ny, nx, 2, 2)


def init_ica(ref_lvl, tile_size):
    """Gradients + per-tile Hessians for one pyramid level of the ref image."""
    h, w = ref_lvl.shape
    ny, nx = h // tile_size, w // tile_size
    gradx, grady = sobel_gradients(ref_lvl)

    def tiles(a):
        return a[:ny * tile_size, :nx * tile_size].reshape(
            ny, tile_size, nx, tile_size).transpose(0, 2, 1, 3)

    gx, gy = tiles(gradx), tiles(grady)
    h00 = jnp.sum(gx * gx, axis=(-2, -1))
    h01 = jnp.sum(gx * gy, axis=(-2, -1))
    h11 = jnp.sum(gy * gy, axis=(-2, -1))
    hessian = jnp.stack([jnp.stack([h00, h01], -1),
                         jnp.stack([h01, h11], -1)], -2)
    return IcaRefState(gradx=gradx, grady=grady, hessian=hessian)


def refine_ica(ref_lvl, ica_state, moving, flow, tile_size, n_iter):
    """Run ``n_iter`` Gauss-Newton refinement steps; returns the updated flow.

    ``flow``: (ny, nx, 2) in (x, y) order, modified per tile.
    """
    ny, nx, _ = flow.shape
    ts = tile_size
    h, w = moving.shape

    def tiles(a):
        return a[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).transpose(0, 2, 1, 3)

    ref_c = tiles(ref_lvl)                       # (ny, nx, ts, ts)
    gx = tiles(ica_state.gradx)
    gy = tiles(ica_state.grady)

    hs = ica_state.hessian
    a00, a01 = hs[..., 0, 0], hs[..., 0, 1]
    a10, a11 = hs[..., 1, 0], hs[..., 1, 1]
    det = a00 * a11 - a01 * a10
    solvable = jnp.abs(det) >= 1e-10
    det_inv = jnp.where(solvable, 1.0 / jnp.where(solvable, det, 1.0), 0.0)

    # per-pixel integer base coordinates of each tile pixel
    base_y = (jnp.arange(ny, dtype=jnp.int32)[:, None, None, None] * ts
              + jnp.arange(ts, dtype=jnp.int32)[None, None, :, None])
    base_x = (jnp.arange(nx, dtype=jnp.int32)[None, :, None, None] * ts
              + jnp.arange(ts, dtype=jnp.int32)[None, None, None, :])

    def tap(fy, fx):
        inb = (fy >= 0) & (fy < h) & (fx >= 0) & (fx < w)
        v = moving[jnp.clip(fy, 0, h - 1), jnp.clip(fx, 0, w - 1)]
        return jnp.where(inb, v, 0.0)

    def body(_, fl):
        ax = fl[..., 0]
        ay = fl[..., 1]
        ix = jnp.trunc(ax)
        iy = jnp.trunc(ay)
        frac_x = (ax - ix)[..., None, None]
        frac_y = (ay - iy)[..., None, None]

        fy = base_y + iy.astype(jnp.int32)[..., None, None]
        fx = base_x + ix.astype(jnp.int32)[..., None, None]

        m00 = tap(fy, fx)
        m01 = tap(fy, fx + 1)
        m10 = tap(fy + 1, fx)
        m11 = tap(fy + 1, fx + 1)

        top = m00 + (m01 - m00) * frac_x
        bot = m10 + (m11 - m10) * frac_x
        interp = top + (bot - top) * frac_y

        gradt = interp - ref_c
        b0 = jnp.sum(-gx * gradt, axis=(-2, -1))
        b1 = jnp.sum(-gy * gradt, axis=(-2, -1))

        dx = det_inv * (a11 * b0 - a01 * b1)
        dy = det_inv * (-a10 * b0 + a00 * b1)
        upd = fl + jnp.stack([dx, dy], axis=-1)
        return jnp.where(solvable[..., None], upd, fl)

    # unrolled: n_iter is a static config constant (default 3); whether a
    # lax.fori_loop is exact and faster on the GPU is untested (ROADMAP S6)
    fl = flow.astype(DEFAULT_FLOAT)
    for k in range(int(n_iter)):
        fl = body(k, fl)
    return fl


def refine_ica_tiled(ref_lvl, ica_state, moving, flow, tile_size, n_iter):
    """Gather-free ``refine_ica``: per-tile dynamic-slice bilinear windows.

    The warp offset is constant within a tile (one flow per tile), so each
    Gauss-Newton iteration reads one contiguous (ts+1)^2 window of the moving
    image per tile (zero-padded out of bounds) instead of 4 full-image
    gathers. Numerically identical to :func:`refine_ica`.
    """
    ny, nx, _ = flow.shape
    ts = tile_size
    h, w = moving.shape

    def tiles(a):
        return a[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).transpose(0, 2, 1, 3)

    ref_c = tiles(ref_lvl)
    gx = tiles(ica_state.gradx)
    gy = tiles(ica_state.grady)

    hs = ica_state.hessian
    a00, a01 = hs[..., 0, 0], hs[..., 0, 1]
    a10, a11 = hs[..., 1, 0], hs[..., 1, 1]
    det = a00 * a11 - a01 * a10
    solvable = jnp.abs(det) >= 1e-10
    det_inv = jnp.where(solvable, 1.0 / jnp.where(solvable, det, 1.0), 0.0)

    PAD = ts + 2
    pad = jnp.pad(moving, PAD)
    base_y = jnp.arange(ny, dtype=jnp.int32)[:, None] * ts     # (ny, 1)
    base_x = jnp.arange(nx, dtype=jnp.int32)[None, :] * ts     # (1, nx)

    def body(_, fl):
        ax = fl[..., 0]
        ay = fl[..., 1]
        ix = jnp.trunc(ax)
        iy = jnp.trunc(ay)
        frac_x = (ax - ix)[..., None, None]
        frac_y = (ay - iy)[..., None, None]

        tops = jnp.clip(base_y + iy.astype(jnp.int32), -PAD, h) + PAD
        lefts = jnp.clip(base_x + ix.astype(jnp.int32), -PAD, w) + PAD

        def one(t, l):
            return jax.lax.dynamic_slice(pad, (t, l), (ts + 1, ts + 1))

        win = jax.vmap(jax.vmap(one))(tops, lefts)       # (ny, nx, ts+1, ts+1)
        m00 = win[..., :ts, :ts]
        m01 = win[..., :ts, 1:]
        m10 = win[..., 1:, :ts]
        m11 = win[..., 1:, 1:]

        top = m00 + (m01 - m00) * frac_x
        bot = m10 + (m11 - m10) * frac_x
        interp = top + (bot - top) * frac_y

        gradt = interp - ref_c
        b0 = jnp.sum(-gx * gradt, axis=(-2, -1))
        b1 = jnp.sum(-gy * gradt, axis=(-2, -1))

        dx = det_inv * (a11 * b0 - a01 * b1)
        dy = det_inv * (-a10 * b0 + a00 * b1)
        upd = fl + jnp.stack([dx, dy], axis=-1)
        return jnp.where(solvable[..., None], upd, fl)

    # unrolled: n_iter is a static config constant (default 3); whether a
    # lax.fori_loop is exact and faster on the GPU is untested (ROADMAP S6)
    fl = flow.astype(DEFAULT_FLOAT)
    for k in range(int(n_iter)):
        fl = body(k, fl)
    return fl
