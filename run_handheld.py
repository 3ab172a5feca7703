#!/usr/bin/env python
"""CLI driver: burst folder/bundle -> PNG / TIFF / DNG.

JAX equivalent of the reference CLI (reference run_handheld.py):
YAML config + dotted key=value overrides, parameter banner, processing, and
dispatch save (PNG via cv2, DNG via the exiftool/dng_validate toolchain),
plus the robustness-mask PNG export.

Usage:
    python run_handheld.py --impath <burst_dir_or_npz> --outpath out.png \
        [--config my.yaml] [scale=2 ica.tuning.n_iter=4 ...]

Runs on JAX's default device (``JAX_PLATFORMS=cpu`` selects the CPU);
``--config`` needs PyYAML.
"""

import argparse
import os
from pathlib import Path

import numpy as np

from hmsr_tpu import process
from hmsr_tpu.configs import default_config, load_yaml, merge, update
from hmsr_tpu.utils.compile_cache import enable_compile_cache


def str2bool(v):
    v = str(v)
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise TypeError()


def parse_value(value):
    try:
        return str2bool(value)
    except TypeError:
        pass
    try:
        return eval(value, {"__builtins__": {}})
    except Exception:
        return value


def print_parameters(config):
    print("\nParameters:\n")
    print(f"  Upscaling factor:       {config.scale}\n")
    if config.scale == 1:
        print("    Demosaicking mode")
    else:
        print("    Super-resolution mode.")
        if config.scale > 2:
            print("    WARNING: sensor integration and lens blur bound the recoverable")
            print("             aliasing; factors above x2 rarely add real detail (see paper).")
    print()
    if config.robustness.enabled:
        print("  Robustness:             enabled")
        print("  ------------------------------")
        print(f"  t:                      {config.robustness.tuning.t:.2f}")
        print(f"  s1:                     {config.robustness.tuning.s1:.2f}")
        print(f"  s2:                     {config.robustness.tuning.s2:.2f}")
        print(f"  Mt:                     {config.robustness.tuning.Mt:.2f}")
        ard = config.accumulated_robustness_denoiser
        if ard.median.enabled or ard.gauss.enabled or ard.merge.enabled:
            print("  Robustness denoising:   enabled")
    else:
        print("  Robustness:             disabled")
    print("\n  Alignment:")
    print("  ------------------------------")
    print(f"  ICA Iterations:         {config.ica.tuning.n_iter}")
    print("\n  Fusion:")
    print("  ------------------------------")
    print(f"  Kernel shape:           {config.merging.kernel}")
    print(f"  k_stretch:              {config.merging.tuning.k_stretch:.2f}")
    print(f"  k_shrink:               {config.merging.tuning.k_shrink:.2f}")
    for k in ("k_detail", "k_denoise"):
        v = config.merging.tuning[k]
        print(f"  {k}:               {'SNR based' if isinstance(v, str) else f'{v:.2f}'}")
    if config.noise_model.alpha is not None:
        print(f"  alpha:                  {config.noise_model.alpha:.2e}")
        print(f"  beta:                   {config.noise_model.beta:.2e}")
    print()


def imsave(fname, rgb_8bit):
    """PNG save with optional backends: cv2 > imageio > PIL (cv2 is treated
    as optional everywhere else in the package, e.g. raw2rgb tonemapping)."""
    try:
        import cv2
        cv2.imwrite(str(fname), cv2.cvtColor(rgb_8bit, cv2.COLOR_RGB2BGR))
        return
    except ImportError:
        pass
    try:
        import imageio.v3 as iio
        iio.imwrite(str(fname), rgb_8bit)
        return
    except ImportError:
        pass
    try:
        from PIL import Image
        Image.fromarray(rgb_8bit).save(str(fname))
        return
    except ImportError:
        raise ImportError(
            "Saving PNGs requires one of cv2, imageio or PIL; none found.")


def main():
    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, help="Path to custom config YAML")
    parser.add_argument("--impath", type=str, required=True, help="Input burst path")
    parser.add_argument("--outpath", type=str, required=True, help="Output image path")
    parser.add_argument("overrides", nargs="*",
                        help="Overrides in key=value form, e.g. ica.tuning.n_iter=4")
    args = parser.parse_args()

    config = default_config()
    if args.config:
        config = merge(config, load_yaml(args.config))
    for item in args.overrides:
        key, value = item.split("=", 1)
        update(config, key, parse_value(value))

    print_parameters(config)

    if config.noise_model.alpha or config.noise_model.beta:
        assert config.noise_model.beta and config.noise_model.alpha, \
            "Both alpha and beta should be provided"

    outpath = Path(args.outpath)
    if outpath.suffix == ".dng":
        config.postprocessing.enabled = False

    print("Processing with handheld super-resolution")
    output, debug = process(args.impath, config)
    output = np.clip(np.nan_to_num(output), 0, 1)
    if output.ndim == 3 and output.shape[-1] == 1:
        output = np.repeat(output, 3, axis=-1)

    if outpath.suffix == ".dng":
        import glob
        from hmsr_tpu.io.dng import save_as_dng
        ref_img_path = glob.glob(os.path.join(args.impath, "*.dng"))[0]
        save_as_dng(output, ref_img_path, outpath)
    else:
        imsave(outpath, (output * 255 + 0.5).astype(np.uint8))

    if config.robustness.get("save_mask", False) and \
            debug.get("accumulated_robustness", None) is not None:
        rob = debug["accumulated_robustness"]
        n = rob.max() if rob.max() > 0 else 1
        rob = np.repeat((rob / n)[..., None], 3, axis=-1)
        rob = np.repeat(np.repeat(rob, max(1, output.shape[0] // rob.shape[0]), 0),
                        max(1, output.shape[1] // rob.shape[1]), 1)
        rob = rob[:output.shape[0], :output.shape[1]]
        imsave(outpath.with_suffix(".rob.png"), (rob * 255 + 0.5).astype(np.uint8))


if __name__ == "__main__":
    main()
