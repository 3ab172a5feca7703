#!/usr/bin/env python
"""Offline noise-curve generation (the reference's monte_carlo_simulation.py).

Writes ``data/noise_model_{std,diff}_ISO_{iso}.npy`` (1001-entry float64
curves) for a camera whose affine noise model scales linearly with ISO:
alpha(iso) = alpha100 * iso/100, beta(iso) = beta100 * (iso/100)^2.

Usage:
    python tools/generate_noise_curves.py --alpha100 1.8071e-4 \
        --beta100 3.1938e-6 --outdir data [--isos 100 200 400 800 1600 3200]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha100", type=float, required=True,
                    help="alpha at ISO 100")
    ap.add_argument("--beta100", type=float, required=True,
                    help="beta at ISO 100")
    ap.add_argument("--outdir", default="data")
    ap.add_argument("--isos", type=int, nargs="*",
                    default=[100, 200, 400, 800, 1600, 3200])
    ap.add_argument("--fast", action="store_true",
                    help="use the linearity-bound interpolation (run_fast_MC)")
    args = ap.parse_args()

    from hmsr_tpu.noise import run_fast_MC, monte_carlo_curves

    os.makedirs(args.outdir, exist_ok=True)
    for iso in args.isos:
        k = iso / 100.0
        alpha = args.alpha100 * k
        beta = args.beta100 * k * k
        fn = run_fast_MC if args.fast else monte_carlo_curves
        std, diff = fn(alpha, beta)
        np.save(os.path.join(args.outdir, f"noise_model_std_ISO_{iso}.npy"),
                np.asarray(std, np.float64))
        np.save(os.path.join(args.outdir, f"noise_model_diff_ISO_{iso}.npy"),
                np.asarray(diff, np.float64))
        print(f"ISO {iso}: alpha={alpha:.3e} beta={beta:.3e} -> curves saved")


if __name__ == "__main__":
    main()
