"""Tile-wise translational block matching (integer flow refinement).

Rebuild of the reference's two matching paths (reference block_matching.py):

- **L2**: the reference computes tile/search-window cross-correlation through
  batched FFTs plus a box-filter windowed L2 norm, then ``argmin(L2 - 2*corr)``
  (block_matching.py:20-76). Because the reference zero-pads each reference
  tile to the search size, its circular FFT correlation restricted to the
  kept +/-R window equals the *direct* linear correlation — so we evaluate
  the correlation directly as (2R+1)^2 fused multiply-reduce contractions
  (no small non-power-of-two FFTs). An FFT backend is kept for
  cross-checking.

- **L1**: the reference launches shared-memory CUDA kernels per tile size
  (block_matching.py:105-345) with an exhaustive (2R+1)^2 shift loop. Here it
  is the same exhaustive search as a vectorized absolute-difference reduce.
  NOTE: the reference kernels' final argmin scan is buggy (inverted
  comparison reading an uninitialized register, block_matching.py:168-180);
  we implement the *intended* argmin (matching the L2 path and the IPOL
  description).

Flow conventions preserved exactly: search windows gathered at
``round(flow)`` (banker's rounding, torch/numpy semantics); L2 *adds* the
integer displacement to the unrounded flow; L1 *replaces* the flow with
``round(flow) + displacement``; L2 gathers clamp coordinates to the image,
L1 windows zero-fill out-of-bounds pixels.
"""

import jax
import jax.numpy as jnp

from ..ops.stencils import box_sum_valid
from ..utils.types import DEFAULT_FLOAT


def extract_flow_patches(moving, flow, tile_size, radius, fill=None):
    """Per-tile search windows of size (ts + 2r)^2 at round(flow).

    ``moving``: (H, W); ``flow``: (ny, nx, 2) in (x, y) order.
    ``fill=None`` clamps coordinates (reference L2 path,
    block_matching.py:348-378); a float fills out-of-bounds with that value
    (reference L1 kernels).

    Gather-free: each window is a CONTIGUOUS index range, so per-pixel
    coordinate clamping equals reading an edge-padded image (and zero fill
    equals a zero-padded image) at a per-tile dynamic offset — one vmapped
    dynamic_slice per tile instead of a 12MP gather.
    """
    ny, nx, _ = flow.shape
    ts, r = tile_size, radius
    search = 2 * r + ts
    h, w = moving.shape

    PAD = search
    if fill is None:
        pad = jnp.pad(moving, PAD, mode="edge")
    else:
        pad = jnp.pad(moving, PAD, constant_values=jnp.asarray(fill, moving.dtype))

    iflow = jnp.round(flow).astype(jnp.int32)
    top = jnp.arange(ny, dtype=jnp.int32)[:, None] * ts + iflow[..., 1] - r
    left = jnp.arange(nx, dtype=jnp.int32)[None, :] * ts + iflow[..., 0] - r
    # windows fully outside the image read pure padding after this clip
    top = jnp.clip(top, -PAD, h) + PAD
    left = jnp.clip(left, -PAD, w) + PAD

    def one(t, l):
        return jax.lax.dynamic_slice(pad, (t, l), (search, search))

    return jax.vmap(jax.vmap(one))(top, left)


def _direct_correlation(ref_tiles, search_area, tile_size, radius):
    """corr[..., sy, sx] = sum_tile ref * search[sy:sy+ts, sx:sx+ts]."""
    ts, r = tile_size, radius
    n_sh = 2 * r + 1
    rows = []
    for sy in range(n_sh):
        row = []
        for sx in range(n_sh):
            win = search_area[..., sy:sy + ts, sx:sx + ts]
            row.append(jnp.sum(ref_tiles * win, axis=(-2, -1)))
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)   # (ny, nx, n_sh, n_sh)


def _fft_correlation(ref_tiles_padded_fft, search_area, tile_size, radius):
    """Reference-style FFT correlation; numerically equals the direct path."""
    ts, r = tile_size, radius
    search = ts + 2 * r
    corr_size = 2 * r + 1
    mov_fft = jnp.fft.rfft2(search_area)
    corrs = jnp.fft.irfft2(jnp.conj(ref_tiles_padded_fft) * mov_fft,
                           s=(search, search))
    corrs = jnp.fft.fftshift(corrs, axes=(-2, -1))
    crop = (search - 1 - corr_size) // 2
    return corrs[..., crop + 1:crop + corr_size + 1, crop + 1:crop + corr_size + 1]


def match_l2(ref_tiles, moving, flow, tile_size, radius, backend="direct"):
    """One level of L2 block matching; returns the updated float flow.

    ``ref_tiles``: (ny, nx, ts, ts) reference tiles (precomputed at init).
    """
    ts, r = tile_size, radius
    corr_size = 2 * r + 1

    search_area = extract_flow_patches(moving, flow, ts, r, fill=None)

    if backend == "direct":
        corrs = _direct_correlation(ref_tiles, search_area, ts, r)
    else:
        pad = jnp.pad(ref_tiles, ((0, 0), (0, 0), (r, r), (r, r)))
        corrs = _fft_correlation(jnp.fft.rfft2(pad), search_area, ts, r)

    l2_search = box_sum_valid(search_area * search_area, ts)
    err = l2_search - 2.0 * corrs

    flat = err.reshape(*err.shape[:-2], corr_size * corr_size)
    idx = jnp.argmin(flat, axis=-1)
    dy = (idx // corr_size - r).astype(DEFAULT_FLOAT)
    dx = (idx % corr_size - r).astype(DEFAULT_FLOAT)
    return flow + jnp.stack([dx, dy], axis=-1)


def match_l1(ref_lvl, moving, flow, tile_size, radius):
    """One level of exhaustive L1 search; returns the updated float flow.

    ``ref_lvl``: the full reference level image; tiles are carved from its
    top-left ny*ts x nx*ts region (the tile grid is defined by the flow shape).
    """
    ny, nx, _ = flow.shape
    ts, r = tile_size, radius
    n_sh = 2 * r + 1

    ref_tiles = ref_lvl[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).transpose(0, 2, 1, 3)

    s_flow = jnp.round(flow)
    search_area = extract_flow_patches(moving, s_flow, ts, r, fill=0.0)

    rows = []
    for sy in range(n_sh):
        row = []
        for sx in range(n_sh):
            win = search_area[..., sy:sy + ts, sx:sx + ts]
            row.append(jnp.sum(jnp.abs(ref_tiles - win), axis=(-2, -1)))
        rows.append(jnp.stack(row, axis=-1))
    err = jnp.stack(rows, axis=-2)    # (ny, nx, n_sh, n_sh)

    flat = err.reshape(ny, nx, n_sh * n_sh)
    idx = jnp.argmin(flat, axis=-1)
    dy = (idx // n_sh - r).astype(DEFAULT_FLOAT)
    dx = (idx % n_sh - r).astype(DEFAULT_FLOAT)
    return s_flow + jnp.stack([dx, dy], axis=-1)
