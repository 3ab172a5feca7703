#!/usr/bin/env python
"""PSNR-at-scale accuracy artifact (ACCURACY_r*.json).

Two scores, recorded next to every round's seconds number (BASELINE.md's
>= 50 dB parity target; the reference validates via the IPOL demo, its
README.md:3-9):

1. ``psnr_vs_truth_db``  — x2 SR output vs the synthetic ground truth the
   burst was rendered from (hmsr_tpu/io/synthetic.py), at >= 512x512 raw.
   This measures actual reconstruction quality end-to-end.
2. ``psnr_vs_oracle_db`` — x2 SR output vs the composed float64 scalar
   oracle (tests/oracles/numpy_pipeline.py) on the same burst. The oracle
   mirrors the reference's math verbatim, so this is the committed stand-in
   for "PSNR vs the Numba-CUDA reference output" without CUDA hardware.
   The scalar oracle is pure Python loops, so this runs at the largest
   size that completes in minutes (default 128x128; override --oracle-size).

Usage: python tools/score_accuracy.py [--size 512] [--frames 20]
           [--oracle-size 128] [--oracle-frames 4] [--out ACCURACY_r03.json]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import numpy as np


def psnr(a, b, peak=1.0):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def build_config(h, w, alpha, beta, ts=16):
    from hmsr_tpu.configs import (default_config, update_snr_config,
                                  sanitize_config)
    c = default_config()
    c.scale = 2
    c.mode = "bayer"
    c.verbose = 0
    c.noise_model.alpha = alpha
    c.noise_model.beta = beta
    c.accumulated_robustness_denoiser.enabled = False
    # resolve SNR-based knobs at the bright tier (Ts=16) like the bench
    update_snr_config(c, 56.0 if ts == 16 else (20.0 if ts == 32 else 10.0))
    sanitize_config(c, (h, w))
    return c


def flat_curves(alpha, beta):
    b = np.arange(1001) / 1000.0
    std = np.sqrt(np.maximum(alpha * b + beta, 0)).astype(np.float32)
    diff = (np.sqrt(2 / np.pi) *
            np.sqrt(2 * (alpha * b + beta) / 9)).astype(np.float32)
    return std, diff


def run_jax_pipeline(ref, comps, config, cfa, wb, std, diff):
    import jax.numpy as jnp
    from hmsr_tpu.models.pipeline import make_pipeline
    pipe = make_pipeline(config, cfa, wb)
    img, _ = pipe(jnp.asarray(ref), jnp.asarray(comps),
                  jnp.asarray(std), jnp.asarray(diff))
    return np.asarray(img)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--oracle-size", type=int, default=128)
    ap.add_argument("--oracle-frames", type=int, default=4)
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--skip-robustness", action="store_true")
    ap.add_argument("--occlusion-size", type=int, default=384)
    ap.add_argument("--occlusion-frames", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from hmsr_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from hmsr_tpu.io.synthetic import make_synthetic_burst, DEFAULT_CFA
    ALPHA, BETA = 1.8e-4, 3.0e-6
    WB = [1.0, 1.0, 1.0]
    result = {"alpha": ALPHA, "beta": BETA}

    # ---- 1. PSNR vs synthetic ground truth at scale
    h = w = args.size
    ref, comps, truth, _ = make_synthetic_burst(
        h, w, n_frames=args.frames, alpha=ALPHA, beta=BETA, seed=7,
        max_shift=2.0)
    config = build_config(h, w, ALPHA, BETA)
    std, diff = flat_curves(ALPHA, BETA)
    t0 = time.time()
    img = run_jax_pipeline(ref, comps, config, DEFAULT_CFA, WB, std, diff)
    t_jax = time.time() - t0
    # borders carry no multi-frame data (alignment pad + merge support):
    # crop one alignment tile (in HR units) all around before scoring
    crop = 2 * int(config.block_matching.tuning.tile_size)
    inner = np.s_[crop:-crop, crop:-crop]
    img_c = np.nan_to_num(img[inner], nan=0.0)
    psnr_truth = psnr(img_c, truth[inner])
    result.update({
        "truth": {"size": [h, w], "frames": args.frames,
                  "crop_px": crop, "psnr_db": round(psnr_truth, 3),
                  "jax_seconds": round(t_jax, 2)}})
    print(f"[truth {h}x{w} x{args.frames}] PSNR = {psnr_truth:.2f} dB "
          f"(jax run {t_jax:.1f}s)", flush=True)

    # ---- 2. PSNR vs the composed float64 scalar oracle
    if not args.skip_oracle:
        from oracles import numpy_pipeline
        oh = ow = args.oracle_size
        oref, ocomps, _, _ = make_synthetic_burst(
            oh, ow, n_frames=args.oracle_frames, alpha=ALPHA, beta=BETA,
            seed=13, max_shift=1.5)
        oconfig = build_config(oh, ow, ALPHA, BETA)
        oimg = run_jax_pipeline(oref, ocomps, oconfig, DEFAULT_CFA, WB,
                                std, diff)
        t0 = time.time()
        want, _, _ = numpy_pipeline.run_pipeline(
            oref, ocomps, std.astype(np.float64), diff.astype(np.float64),
            oconfig, DEFAULT_CFA, WB)
        t_oracle = time.time() - t0
        finite = np.isfinite(oimg) & np.isfinite(want)
        inner = np.zeros_like(finite)
        inner[2:-2, 2:-2] = True        # borders may under/overflow in f32
        m = finite & inner
        psnr_oracle = psnr(oimg[m], want[m])
        mae = float(np.mean(np.abs(oimg[m] - want[m])))
        result.update({
            "oracle": {"size": [oh, ow], "frames": args.oracle_frames,
                       "psnr_db": round(psnr_oracle, 3),
                       "mean_abs_err": mae,
                       "oracle_seconds": round(t_oracle, 1)}})
        print(f"[oracle {oh}x{ow} x{args.oracle_frames}] PSNR = "
              f"{psnr_oracle:.2f} dB, MAE = {mae:.3g} "
              f"(oracle {t_oracle:.0f}s)", flush=True)

    # ---- 3. Robustness value on a LOCAL-MOTION scene (VERDICT r03 #6):
    # a textured disc moves ~6 raw px/frame, so aligned comp frames show it
    # elsewhere; robustness must reject that content. Score the x2 SR
    # output vs truth with robustness ON vs OFF, globally and on the
    # ghost-prone region (union of the disc's footprints).
    if not args.skip_robustness:
        from hmsr_tpu.io.synthetic import make_occlusion_burst
        oh = ow = args.occlusion_size
        rref, rcomps, rtruth, ghost = make_occlusion_burst(
            oh, ow, n_frames=args.occlusion_frames, alpha=ALPHA, beta=BETA,
            seed=21, max_shift=2.0)
        rconfig = build_config(oh, ow, ALPHA, BETA)
        crop = 2 * int(rconfig.block_matching.tuning.tile_size)
        inner = np.zeros(ghost.shape, bool)
        inner[crop:-crop, crop:-crop] = True
        rob = {"size": [oh, ow], "frames": args.occlusion_frames,
               "ghost_fraction": round(float(ghost[inner].mean()), 4)}
        for label, enabled in (("on", True), ("off", False)):
            c = build_config(oh, ow, ALPHA, BETA)
            c.robustness.enabled = enabled
            if not enabled:
                c.robustness.save_mask = False
            img = run_jax_pipeline(rref, rcomps, c, DEFAULT_CFA, WB,
                                   std, diff)
            img = np.nan_to_num(img, nan=0.0)
            g = inner & ghost
            rob[f"psnr_ghost_{label}_db"] = round(
                psnr(img[g], rtruth[g]), 3)
            rob[f"psnr_global_{label}_db"] = round(
                psnr(img[inner], rtruth[inner]), 3)
            print(f"[occlusion {oh}x{ow} x{args.occlusion_frames} rob={label}] "
                  f"ghost PSNR = {rob[f'psnr_ghost_{label}_db']:.2f} dB, "
                  f"global = {rob[f'psnr_global_{label}_db']:.2f} dB",
                  flush=True)
        result["robustness_value"] = rob

    out = args.out or "ACCURACY.json"
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
