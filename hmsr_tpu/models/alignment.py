"""Coarse-to-fine alignment coordinator.

Rebuild of reference alignment.py: per-frame optical flow as a Gaussian
pyramid descent of {upscale flow -> integer block matching -> sub-pixel ICA}.

Parity notes:
- the reference circularly pads the *reference* grey image to a tile-size
  multiple (alignment.py:27-37) but builds the moving pyramid from the
  unpadded frame (alignment.py:87-94); both behaviors are kept (all gathers
  handle the shape mismatch explicitly);
- reference tiles / gradients / Hessians / (FFT of padded tiles in the
  reference) are precomputed once per burst in :func:`init_alignment` and
  reused for every frame — this state stays in device memory across the
  ``lax.scan`` over frames;
- flow upscaling between levels re-tiles by ``factor // (ts_new // ts_prev)``
  with nearest (default) / bilinear / bicubic interpolation, scales by the
  pyramid factor, and zero-pads the bottom/right tile rows
  (alignment.py:150-172).

Everything is shape-static: the pyramid is a Python list of fixed-shape
levels, unrolled under jit.
"""

from typing import List, NamedTuple

import jax
import jax.image
import jax.numpy as jnp

from ..ops.pyramid import build_gaussian_pyramid
from .block_matching import match_l1, match_l2
from .ica import IcaRefState, init_ica, refine_ica, refine_ica_tiled
from ..utils.types import DEFAULT_FLOAT


class AlignmentRefState(NamedTuple):
    """Per-burst precomputed reference-frame state (coarse-first lists)."""
    pyramid: List[jnp.ndarray]        # level images
    tiles: List[jnp.ndarray]          # (ny, nx, ts, ts) reference tiles
    ica: List[IcaRefState]


def _level_tile_sizes(config):
    """(factor, tile_size, radius, metric) per level, coarse-first."""
    t = config.block_matching.tuning
    n = len(t.factors)
    out = []
    for l in range(n):             # l: coarse-first index
        list_id = n - l - 1        # fine-first index used by the config lists
        out.append((t.factors[list_id], t.tile_sizes[list_id],
                    t.search_radii[list_id], t.metrics[list_id]))
    return out


def _unfold_tiles(lvl, ts):
    h, w = lvl.shape
    ny, nx = h // ts, w // ts
    return lvl[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).transpose(0, 2, 1, 3)


def init_alignment(ref_grey, config):
    """Precompute the alignment state of the reference image."""
    t = config.block_matching.tuning
    Ts = t.tile_size
    h, w = ref_grey.shape
    pad_b = (Ts - h % Ts) % Ts
    pad_r = (Ts - w % Ts) % Ts
    padded = jnp.pad(ref_grey, ((0, pad_b), (0, pad_r)), mode="wrap")

    pyramid = build_gaussian_pyramid(padded, t.factors)

    tiles, ica_states = [], []
    for lvl, (_, ts, _, _) in zip(pyramid, _level_tile_sizes(config)):
        tiles.append(_unfold_tiles(lvl, ts))
        ica_states.append(init_ica(lvl, ts))
    return AlignmentRefState(pyramid=pyramid, tiles=tiles, ica=ica_states)


def upscale_flow(flow, npatches, list_id, config):
    """Re-tile + rescale the flow for the next (finer) pyramid level."""
    t = config.block_matching.tuning
    new_ts = t.tile_sizes[list_id]
    prev_ts = t.tile_sizes[list_id + 1]
    factor = t.factors[list_id + 1]
    repeat = factor // (new_ts // prev_ts)

    mode = t.flow_upscale_mode
    if repeat == 1:
        up = flow
    elif mode == "nearest":
        up = jnp.repeat(jnp.repeat(flow, repeat, axis=0), repeat, axis=1)
    else:
        method = {"bilinear": "bilinear", "bicubic": "cubic"}[mode]
        up = jax.image.resize(flow, (flow.shape[0] * repeat,
                                     flow.shape[1] * repeat, 2), method=method)
    up = up * float(factor)

    ny, nx = npatches
    if up.shape[0] < ny or up.shape[1] < nx:
        up = jnp.pad(up, ((0, ny - up.shape[0]), (0, nx - up.shape[1]), (0, 0)))
    return up


def align(ref_state, moving_grey, config):
    """Estimate the per-tile optical flow of ``moving_grey`` vs the reference.

    Returns (ny, nx, 2) flow in (x, y) raw-pixel units at the finest level.
    """
    t = config.block_matching.tuning
    n_iter = config.ica.tuning.n_iter
    backend = config.get("tpu", {}).get("correlation", "direct")
    ica_fn = refine_ica if config.get("tpu", {}).get("ica_impl", "auto") \
        == "gather" else refine_ica_tiled

    moving_pyramid = build_gaussian_pyramid(moving_grey, t.factors)
    levels = _level_tile_sizes(config)
    n_lvls = len(levels)

    # profiling knob: truncate the descent after k levels; the remaining
    # levels return upscaled flow only. Guarded: truncated flow silently
    # corrupts output, so it refuses to run unless the profiling harness
    # has set HMSR_DEBUG_TRUNC=1.
    max_lvls = int(config.get("tpu", {}).get("align_levels", n_lvls))
    if max_lvls < n_lvls:
        import os
        if os.environ.get("HMSR_DEBUG_TRUNC") != "1":
            raise ValueError(
                "tpu.align_levels is a profiling-only knob that truncates "
                "the alignment descent (flow becomes meaningless). Unset it, "
                "or set HMSR_DEBUG_TRUNC=1 if you are bisecting performance.")

    flow = None
    for l in range(n_lvls):
        list_id = n_lvls - l - 1
        _, ts, radius, metric = levels[l]
        ref_lvl = ref_state.pyramid[l]
        npatches = ref_state.tiles[l].shape[:2]

        if flow is None:
            flow = jnp.zeros((*npatches, 2), dtype=DEFAULT_FLOAT)
        else:
            flow = upscale_flow(flow, npatches, list_id, config)

        if l >= max_lvls:
            continue

        moving_lvl = moving_pyramid[l]
        if metric == "L2":
            flow = match_l2(ref_state.tiles[l], moving_lvl, flow, ts, radius,
                            backend=backend)
        elif metric == "L1":
            flow = match_l1(ref_lvl, moving_lvl, flow, ts, radius)
        else:
            raise ValueError(f"Unknown block matching metric {metric}")

        flow = ica_fn(ref_lvl, ref_state.ica[l], moving_lvl, flow, ts, n_iter)

    return flow
