"""Multi-device burst processing: DP over frames x SP over the HR accumulator.

The reference is single-GPU (SURVEY.md section 2.3); this pipeline scales
over a ('frames', 'space') device mesh:

- **frames axis (data parallel)**: burst frames are sharded across devices;
  each device aligns/weights/merges its local frames into partial num/den
  accumulators, which are ``psum``-reduced — the accumulator formulation
  makes the merge embarrassingly reducible;
- **space axis (spatial parallel)**: the HR num/den grid is sharded by row
  blocks; each device only evaluates the merge for its block (the row-offset
  parameter of the merges), bounding HR memory per device.

Reference-frame precomputations are replicated (they are amortized once per
burst). Communication: one psum of (num, den, acc_r) per burst — bandwidth
O(HR image), latency-insensitive. Every device reaches every other at the
same rate, so the mesh shape follows the algorithm alone.

Frame-count divisibility is handled by zero-weight padding frames: the
per-frame weight multiplies the robustness mask, so padded frames contribute
exactly nothing to any accumulator.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..configs.params import check_impl_options
from ..models.alignment import align, init_alignment
from ..models.kernels import estimate_kernels
from ..models.pipeline import flow_to_raw_grid, merge_ref_banded
from ..models.merge import merge
from ..models.merge_tiled import merge_tiled
from ..models.robustness import compute_robustness, init_robustness
from ..ops.accumfix import REFILL_BORDER, normalize_accum
from ..ops.grey import compute_grey_image
from ..utils.types import DEFAULT_FLOAT


def make_mesh(n_frames_axis, n_space_axis, devices=None):
    """Build a ('frames', 'space') device mesh."""
    if devices is None:
        devices = jax.devices()
    n = n_frames_axis * n_space_axis
    assert len(devices) >= n, (len(devices), n)
    dev = np.array(devices[:n]).reshape(n_frames_axis, n_space_axis)
    return Mesh(dev, ("frames", "space"))


def pad_frames(comp_imgs, n_shards):
    """Pad the frame stack to a multiple of ``n_shards``; returns (frames, weights)."""
    n = comp_imgs.shape[0]
    pad = (-n) % n_shards
    weights = np.ones((n + pad,), np.float32)
    if pad:
        comp_imgs = np.concatenate(
            [comp_imgs, np.zeros((pad, *comp_imgs.shape[1:]), comp_imgs.dtype)])
        weights[n:] = 0.0
    return comp_imgs, weights


def make_sharded_pipeline(config, cfa_pattern, white_balance, mesh, jit=True):
    """Build the sharded pipeline: (ref, comps, weights, std, diff) -> image.

    ``comps``/``weights`` must be padded to a multiple of the mesh's frames
    axis (see :func:`pad_frames`). Output is the full (H*s, W*s, c) image,
    row-sharded over the space axis.
    """
    check_impl_options(config)
    cfa = np.asarray(cfa_pattern)
    wb = [float(x) for x in white_balance]
    n_space = mesh.shape["space"]

    bayer = config.mode == "bayer"
    scale = config.scale
    # per-frame merge: the tile-restructured fast path for integer scales;
    # the exact gather formulation remains the fractional-scale fallback
    integer_scale = float(scale) == int(scale)
    impl = config.get("tpu", {}).get("merge_impl", "auto")
    merge_impl = merge_tiled if (integer_scale and impl != "gather") else merge
    robustness_denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    accumulate_r = bool(robustness_denoise or config.robustness.save_mask)
    debug_mode = bool(config.debug)

    def body(ref_img, comps_local, weights_local, std_curve, diff_curve,
             grey_consts):
        ref_img = ref_img.astype(DEFAULT_FLOAT)
        comps_local = comps_local.astype(DEFAULT_FLOAT)

        grey_method = str(config.get("grey_method", "FFT"))
        decimating = bayer and grey_method == "decimating"
        ts_raw = int(config.block_matching.tuning.tile_size)
        grey_impl = str(config.get("tpu", {}).get("grey_impl", "auto"))
        to_grey = (lambda f: compute_grey_image(f, grey_method,
                                                impl=grey_impl,
                                                consts=grey_consts)) if bayer \
            else (lambda f: f)
        ref_grey = to_grey(ref_img)
        align_state = init_alignment(ref_grey, config)
        ref_stats = init_robustness(ref_img, cfa, wb, (std_curve, diff_curve),
                                    config)

        h, w = ref_img.shape
        out_h, out_w = round(scale * h), round(scale * w)
        n_ch = 3 if bayer else 1
        if out_h % n_space:
            raise ValueError(f"HR height {out_h} must divide into "
                             f"{n_space} space shards")
        block, block_w = out_h // n_space, out_w
        row_offset = jax.lax.axis_index("space") * block

        # mark the initial carries as device-varying over both mesh axes so
        # the scan carry type matches its (frame- and offset-dependent) output
        vary = ("frames", "space")

        def mark_varying(x):
            return jax.lax.pcast(x, vary, to="varying")

        num = mark_varying(jnp.zeros((n_ch, block, block_w), DEFAULT_FLOAT))
        den = mark_varying(jnp.zeros((n_ch, block, block_w), DEFAULT_FLOAT))
        acc_r = mark_varying(jnp.zeros((h, w), DEFAULT_FLOAT)) \
            if accumulate_r else None

        def step(carry, xs):
            num, den, acc_r = carry
            frame, weight = xs
            grey = to_grey(frame)
            flow = align(align_state, grey, config)
            if decimating:
                flow = flow_to_raw_grid(flow, frame.shape, ts_raw)
            r = compute_robustness(frame, ref_stats, flow, cfa, wb, config)
            r = r * weight          # zero-weight padding frames contribute nothing
            if acc_r is not None:
                acc_r = acc_r + r
            covs = estimate_kernels(frame, config)
            num, den = merge_impl(frame, flow, covs, r, num, den, cfa,
                                  config, row_offset=row_offset)
            ys = (flow, r) if debug_mode else None
            return (num, den, acc_r), ys

        (num, den, acc_r), ys = jax.lax.scan(step, (num, den, acc_r),
                                             (comps_local, weights_local))

        # reduce partial accumulators over the frame shards
        num = jax.lax.psum(num, "frames")
        den = jax.lax.psum(den, "frames")
        if acc_r is not None:
            acc_r = jax.lax.psum(acc_r, "frames")

        ref_covs = estimate_kernels(ref_img, config)
        # row-banded gather reference merge: bounded temporaries at 48MP
        num, den = merge_ref_banded(
            ref_img, ref_covs, num, den, cfa, config,
            acc_rob=acc_r if robustness_denoise else None,
            row_offset=row_offset)
        # num/den bands are returned raw; normalization happens on the
        # assembled accumulators OUTSIDE the shard_map (fn below) so the
        # starved-pixel refill of normalize_accum sees full-image context —
        # per-band normalization truncated the 5x5 refill neighborhoods at
        # band edges (band-geometry-dependent output at refill pixels).

        # acc_r is identical on every space shard; a second psum over 'space'
        # (divided back) certifies it replicated for the P() output spec.
        if acc_r is not None:
            acc_out = jax.lax.psum(acc_r, "space") / mesh.shape["space"]
        else:
            acc_out = jax.lax.psum(
                mark_varying(jnp.zeros((1, 1), DEFAULT_FLOAT)),
                ("frames", "space")) * 0.0
        if debug_mode:
            # flow/robustness depend only on the frame axis; psum over
            # 'space' (divided back) certifies them replicated for the
            # frames-sharded output spec (reference debug dict parity,
            # super_resolution.py:152-153 / VERDICT round-1 missing #4).
            flows = jax.lax.psum(ys[0], "space") / n_space
            rmaps = jax.lax.psum(ys[1], "space") / n_space
            return num, den, acc_out, flows, rmaps
        return num, den, acc_out

    out_specs = (P(None, "space"), P(None, "space"), P())
    if debug_mode:
        out_specs = out_specs + (P("frames"), P("frames"))
    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("frames"), P("frames"), P(), P(), P()),
        out_specs=out_specs,
    )

    def fn(ref_img, comps, weights, std_curve, diff_curve, grey_consts=None):
        outs = sharded(ref_img, comps, weights, std_curve, diff_curve,
                       grey_consts)
        num, den = outs[0], outs[1]
        # normalize the assembled accumulators with full-image refill context
        image = jnp.transpose(
            normalize_accum(num, den, refill_border=REFILL_BORDER), (1, 2, 0))
        return (image,) + outs[2:]

    if not jit:
        return fn
    jfn = jax.jit(fn)
    from ..ops.grey import grey_consts_for

    def with_grey_consts(ref_img, comps, weights, std_curve, diff_curve):
        # same transport as make_pipeline: circulants as jit arguments,
        # replicated (P()) across the mesh — see grey.grey_matmul_consts
        return jfn(ref_img, comps, weights, std_curve, diff_curve,
                   grey_consts=grey_consts_for(config, ref_img.shape))

    return with_grey_consts
