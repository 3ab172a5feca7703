"""The end-to-end burst pipeline (Alg. 1), jitted as ONE XLA program.

Rebuild of reference super_resolution.py:41-200 (``main``). Where the
reference runs a Python loop over frames with per-stage kernel launches,
Torch<->Numba handoffs, and hand-placed ``cuda.synchronize()`` barriers, this
pipeline is a single traced program:

- reference-frame precomputations (grey, pyramid, tiles, gradients, Hessians,
  local stats) happen once and stay in device memory;
- the burst is scanned with ``lax.scan`` over device-resident frames. By
  default (``fused``) the scan runs align -> robustness -> kernels per frame
  and one row-slab merge then accumulates every frame
  (:mod:`merge_slab`); the ``scan`` mode merges inside the frame step, with
  the num/den accumulators in the scan carry. Division happens once at the
  end.

One runtime, one array type — the reference's entire synchronization story
(SURVEY.md section 1) vanishes by construction.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..configs.params import check_impl_options
from ..ops.accumfix import REFILL_BORDER, normalize_accum
from ..ops.grey import compute_grey_image
from ..utils.types import DEFAULT_FLOAT
from .alignment import align, init_alignment
from .kernels import estimate_kernels
from .merge import merge, merge_ref
from .merge_tiled import merge_tiled, merge_ref_tiled
from .merge_fused import merge_burst_tiled
from .merge_slab import merge_burst_slab
from .robustness import compute_robustness, init_robustness


def _use_tiled(config):
    impl = config.get("tpu", {}).get("merge_impl", "auto")
    integer_scale = float(config.scale) == int(config.scale)
    if impl == "gather" or (impl == "auto" and not integer_scale):
        return False
    if not integer_scale:
        raise ValueError("tiled merge requires an integer scale")
    return True


def select_merge(config):
    """Pick the per-frame merge: the tiled fast path for integer scales and
    the exact reference-layout gather path for fractional scales."""
    return merge_tiled if _use_tiled(config) else merge


def select_merge_ref(config):
    """Reference-frame merge implementation (see :func:`select_merge`)."""
    if _use_tiled(config):
        return merge_ref_tiled
    return merge_ref_banded


def merge_ref_banded(ref_img, covs, num, den, cfa_pattern, config,
                     acc_rob=None, band_rows=512, row_offset=0):
    """Reference-frame merge evaluated in HR row bands (bounded temporaries).

    Mathematically identical to :func:`merge_ref`; the banding only bounds the
    size of the materialized gather intermediates at 48MP outputs.
    ``row_offset``: global HR row of ``num[:, 0]`` (space-sharded layout).
    """
    n_ch, out_h, out_w = num.shape
    band_rows = min(band_rows, out_h)
    n_bands = -(-out_h // band_rows)
    pad_h = n_bands * band_rows

    def one_band(start):
        nb = jax.lax.dynamic_slice_in_dim(num_p, start, band_rows, 1)
        db = jax.lax.dynamic_slice_in_dim(den_p, start, band_rows, 1)
        return merge_ref(ref_img, covs, nb, db, cfa_pattern, config,
                         acc_rob=acc_rob, row_offset=row_offset + start)

    num_p = jnp.pad(num, ((0, 0), (0, pad_h - out_h), (0, 0)))
    den_p = jnp.pad(den, ((0, 0), (0, pad_h - out_h), (0, 0)))
    starts = jnp.arange(n_bands, dtype=jnp.int32) * band_rows
    nb, db = jax.lax.map(one_band, starts)      # (nb, c, band, W)
    nb = jnp.transpose(nb, (1, 0, 2, 3)).reshape(n_ch, pad_h, out_w)[:, :out_h]
    db = jnp.transpose(db, (1, 0, 2, 3)).reshape(n_ch, pad_h, out_w)[:, :out_h]
    return nb, db


def flow_to_raw_grid(flow, raw_shape, tile_size):
    """Re-tile a decimating-grey flow onto the raw-image tile grid.

    With ``grey_method="decimating"`` alignment runs on the half-resolution
    grey image: its tiles of ``tile_size`` grey pixels cover ``2*tile_size``
    raw pixels and its flow values are in grey-pixel units. Downstream
    consumers (merge.py:104-105, robustness.py:91-92 of this repo, mirroring
    reference merge.py:322-325 / robustness.py:375-384) index tiles and apply
    flow on the RAW grid — the reference's own decimating path hands them the
    half-resolution flow unconverted, which mis-scales the warp; we convert:
    values x2 (grey px -> raw px) and each grey tile repeated 2x2 so raw tile
    ``(i, j)`` reads grey tile ``(i // 2, j // 2)``. Edge-padded/cropped to
    the raw tile count (documented deviation, README "Parity notes").
    """
    ny = -(-raw_shape[0] // tile_size)
    nx = -(-raw_shape[1] // tile_size)
    f = jnp.repeat(jnp.repeat(flow * 2.0, 2, axis=0), 2, axis=1)
    pad_y = max(0, ny - f.shape[0])
    pad_x = max(0, nx - f.shape[1])
    if pad_y or pad_x:
        f = jnp.pad(f, ((0, pad_y), (0, pad_x), (0, 0)), mode="edge")
    return f[:ny, :nx]


def run_pipeline(ref_img, comp_imgs, std_curve, diff_curve, config,
                 cfa_pattern, white_balance, grey_consts=None):
    """Traceable pipeline body. All config/cfa/wb are trace-time constants.

    Returns ``(image, debug)`` where ``image`` is (H*s, W*s, c) num/den and
    ``debug`` holds optional per-frame flows/robustness and the accumulated
    robustness mask.

    ``grey_consts``: optional :func:`hmsr_tpu.ops.grey.grey_matmul_consts`
    pair passed as ARGUMENTS through the caller's jit boundary; None falls
    back to the in-trace circulant expansion (bit-identical). Only the
    optional ``tpu.grey_impl: matmul`` path uses them.
    """
    bayer = config.mode == "bayer"
    scale = config.scale
    debug_mode = bool(config.debug)
    accumulate_r = bool(config.accumulated_robustness_denoiser.get("enabled", False)
                        or config.robustness.save_mask)
    robustness_denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))

    ref_img = ref_img.astype(DEFAULT_FLOAT)
    comp_imgs = comp_imgs.astype(DEFAULT_FLOAT)

    grey_method = str(config.get("grey_method", "FFT"))
    grey_impl = str(config.get("tpu", {}).get("grey_impl", "auto"))
    decimating = bayer and grey_method == "decimating"
    ts_raw = int(config.block_matching.tuning.tile_size)

    def to_grey(frame):
        return compute_grey_image(frame, grey_method, impl=grey_impl,
                                  consts=grey_consts) \
            if bayer else frame

    def to_raw_flow(flow, raw_shape):
        return flow_to_raw_grid(flow, raw_shape, ts_raw) if decimating else flow

    # ---- reference init (amortized across the whole burst)
    ref_grey = to_grey(ref_img)
    align_state = init_alignment(ref_grey, config)
    ref_stats = init_robustness(ref_img, cfa_pattern, white_balance,
                                (std_curve, diff_curve), config)

    h, w = ref_img.shape
    out_h, out_w = round(scale * h), round(scale * w)
    n_ch = 3 if bayer else 1

    pipe_mode = config.get("tpu", {}).get("pipeline", "auto")
    if pipe_mode == "auto":
        # the fused-slab merge needs the integer-scale tile geometry;
        # fractional scales take the per-frame gather merge in the scan
        pipe_mode = "fused" if _use_tiled(config) else "scan"
    fused = pipe_mode == "fused" and _use_tiled(config)

    # channel-first accumulators (c, H*s, W*s)
    merge_fn = select_merge(config)
    num = jnp.zeros((n_ch, out_h, out_w), DEFAULT_FLOAT)
    den = jnp.zeros((n_ch, out_h, out_w), DEFAULT_FLOAT)
    acc_r = jnp.zeros((h, w), DEFAULT_FLOAT) if accumulate_r else None

    debug = {}
    if pipe_mode == "vmapped":
        # batch the analysis phase (align / robustness / kernels — no
        # cross-frame dependencies) across frames with vmap, then scan ONLY
        # the merge (num/den accumulation is the sole sequential
        # dependency). Memory: the same per-frame flow/robustness/covariance
        # stacks the fused mode materializes.
        def analyze_one(frame):
            grey = to_grey(frame)
            flow = to_raw_flow(align(align_state, grey, config), frame.shape)
            r = compute_robustness(frame, ref_stats, flow, cfa_pattern,
                                   white_balance, config)
            covs = estimate_kernels(frame, config)
            return flow, r, covs

        flows, rmaps, covs_stack = jax.vmap(analyze_one)(comp_imgs)
        if acc_r is not None:
            acc_r = jnp.sum(rmaps, axis=0)

        def merge_step(carry, xs):
            num, den = carry
            frame, flow, r, covs = xs
            num, den = merge_fn(frame, flow, covs, r, num, den,
                                cfa_pattern, config)
            return (num, den), None

        (num, den), _ = jax.lax.scan(
            merge_step, (num, den), (comp_imgs, flows, rmaps, covs_stack))
        ref_covs = estimate_kernels(ref_img, config)
        merge_ref_fn = select_merge_ref(config)
        num, den = merge_ref_fn(ref_img, ref_covs, num, den, cfa_pattern,
                                config,
                                acc_rob=acc_r if robustness_denoise else None)
        image = jnp.transpose(
            normalize_accum(num, den, refill_border=REFILL_BORDER),
            (1, 2, 0))
        if debug_mode:
            debug["flow"] = flows
            debug["robustness"] = rmaps
        if acc_r is not None:
            debug["accumulated_robustness"] = acc_r
        return image, debug
    if fused:
        # Phase A (analysis): scan over frames producing per-frame flow,
        # robustness and covariances. Phase B (fused merge): every frame
        # accumulated per HR row slab; num/den are never materialized for
        # the whole image.
        def analyze(acc_r, frame):
            grey = to_grey(frame)
            flow = to_raw_flow(align(align_state, grey, config), frame.shape)
            r = compute_robustness(frame, ref_stats, flow, cfa_pattern,
                                   white_balance, config)
            if acc_r is not None:
                acc_r = acc_r + r
            covs = estimate_kernels(frame, config)
            return acc_r, (flow, r, covs)

        acc_r, (flows, rmaps, covs_stack) = jax.lax.scan(
            analyze, acc_r, comp_imgs)
        ref_covs = estimate_kernels(ref_img, config)
        fused_impl = merge_burst_slab \
            if config.get("tpu", {}).get("fused_impl", "slab") == "slab" \
            else merge_burst_tiled
        image = fused_impl(
            comp_imgs, flows, covs_stack, rmaps, ref_img, ref_covs,
            cfa_pattern, config,
            acc_rob=acc_r if robustness_denoise else None)
        image = jnp.transpose(image, (1, 2, 0))
        if debug_mode:
            debug["flow"] = flows
            debug["robustness"] = rmaps
    else:
        def step(carry, frame):
            num, den, acc_r = carry
            grey = to_grey(frame)
            flow = to_raw_flow(align(align_state, grey, config), frame.shape)
            r = compute_robustness(frame, ref_stats, flow, cfa_pattern,
                                   white_balance, config)
            if acc_r is not None:
                acc_r = acc_r + r
            covs = estimate_kernels(frame, config)
            num, den = merge_fn(frame, flow, covs, r, num, den, cfa_pattern,
                                config)
            ys = (flow, r) if debug_mode else None
            return (num, den, acc_r), ys

        (num, den, acc_r), ys = jax.lax.scan(step, (num, den, acc_r), comp_imgs)

        # ---- reference frame accumulation
        ref_covs = estimate_kernels(ref_img, config)
        merge_ref_fn = select_merge_ref(config)
        num, den = merge_ref_fn(ref_img, ref_covs, num, den, cfa_pattern,
                                config,
                                acc_rob=acc_r if robustness_denoise else None)
        image = jnp.transpose(
            normalize_accum(num, den, refill_border=REFILL_BORDER),
            (1, 2, 0))
        # -> (H*s, W*s, c)
        if debug_mode and ys is not None:
            debug["flow"] = ys[0]
            debug["robustness"] = ys[1]

    if acc_r is not None:
        debug["accumulated_robustness"] = acc_r
    return image, debug


def make_pipeline(config, cfa_pattern, white_balance, jit=True):
    """Build a (jitted) pipeline closure over the static configuration.

    The returned callable takes ``(ref_img, comp_imgs, std_curve, diff_curve)``
    — all device arrays — so noise curves stay data (no retrace per ISO).
    """
    check_impl_options(config)
    cfa = np.asarray(cfa_pattern)
    wb = [float(x) for x in white_balance]
    fn = partial(run_pipeline, config=config, cfa_pattern=cfa, white_balance=wb)
    if not jit:
        return fn
    jfn = jax.jit(fn)
    from ..ops.grey import grey_consts_for

    def with_grey_consts(ref_img, comp_imgs, std_curve, diff_curve):
        # matmul-grey circulants (None on the default FFT path) computed
        # eagerly once per size and fed through the jit boundary as
        # arguments, keeping them out of the program's literals
        return jfn(ref_img, comp_imgs, std_curve, diff_curve,
                   grey_consts=grey_consts_for(config, ref_img.shape))

    return with_grey_consts
