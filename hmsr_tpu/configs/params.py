"""Config validation and SNR-adaptive hyperparameter resolution.

Behavioral parity with the reference (reference params.py:4-123):
- ``sanitize_config`` performs the same enum / exclusivity / tile-divisibility
  checks;
- ``update_snr_config`` resolves the ``"SNR_based"`` sentinels to concrete
  static values (tile size 64/32/16 for SNR<=14/<=22/else, and the four merge
  constants lerped over SNR in [6, 30]).

Everything resolved here is a *trace-time constant* for the jitted pipeline:
tile sizes, pyramid factors, and merge constants are baked into the compiled
program (data-dependent config is resolved on the host before tracing, exactly
as the reference resolves it at config time).
"""

import numpy as np


def lerp(x, x_range, y_range):
    """Linearly interpolate scalar ``x`` from ``x_range`` to ``y_range`` (clamped)."""
    x0, x1 = x_range
    y0, y1 = y_range
    assert x0 < x1
    assert y0 != y1
    t = (x - x0) / (x1 - x0)
    t = max(0.0, min(1.0, t))
    return y0 + (y1 - y0) * t


def update_snr_config(config, SNR):
    """Resolve SNR-based sentinels into concrete hyperparameters (in place)."""
    SNR = float(np.clip(SNR, 6, 30))
    if SNR <= 14:
        Ts = 64
    elif SNR <= 22:
        Ts = 32
    else:
        Ts = 16

    bm = config.block_matching.tuning
    if bm.tile_size != "SNR_based":
        assert isinstance(bm.tile_size, int), "tile_size should be an integer or 'SNR_based'"
        Ts = bm.tile_size
    else:
        bm.tile_size = Ts

    bm.tile_sizes = [int(Ts * s) for s in bm.tile_size_factors]

    mt = config.merging.tuning
    if mt.k_detail == "SNR_based":
        mt.k_detail = lerp(SNR, [6, 30], [0.33, 0.25])
    else:
        assert isinstance(mt.k_detail, float), "k_detail should be a float or 'SNR_based'"
    if mt.k_denoise == "SNR_based":
        mt.k_denoise = lerp(SNR, [6, 30], [5.0, 3.0])
    else:
        assert isinstance(mt.k_denoise, float), "k_denoise should be a float or 'SNR_based'"
    if mt.D_th == "SNR_based":
        mt.D_th = lerp(SNR, [6, 30], [0.81, 0.71])
    else:
        assert isinstance(mt.D_th, float), "D_th should be a float or 'SNR_based'"
    if mt.D_tr == "SNR_based":
        mt.D_tr = lerp(SNR, [6, 30], [1.24, 1])
    else:
        assert isinstance(mt.D_tr, float), "D_tr should be a float or 'SNR_based'"
    return config


#: ``tpu.*`` keys and values that selected the removed Pallas kernels
REMOVED_KEYS = ("pallas_interpret", "merge_chunk", "ica_fused")
REMOVED_VALUES = (("merge_impl", "pallas"), ("ica_impl", "pallas"),
                  ("robustness_impl", "pallas"), ("pipeline", "chunked"))

#: accepted values of the ``tpu.*`` implementation switches
IMPL_CHOICES = {
    "correlation": ("direct", "fft"),
    "merge_impl": ("auto", "tiled", "gather"),
    "robustness_impl": ("auto", "tiled", "gather"),
    "ica_impl": ("auto", "tiled", "gather"),
    "grey_impl": ("auto", "fft", "matmul", "ct"),
    "pipeline": ("auto", "scan", "fused", "vmapped"),
    "fused_impl": ("slab", "tiled"),
    "finishing_impl": ("auto", "device", "host"),
}


def check_impl_options(config):
    """Reject removed or unknown ``tpu.*`` implementation options.

    A removed option raises instead of silently falling back to another
    implementation. Called by :func:`sanitize_config` and by the pipeline
    builders.
    """
    impl = config.get("tpu", None) or {}
    for key in REMOVED_KEYS:
        if key in impl:
            raise ValueError(f"tpu.{key} was removed together with the Pallas "
                             "kernels it configured; delete it")
    for key, value in REMOVED_VALUES:
        if impl.get(key) == value:
            raise ValueError(f"tpu.{key}={value!r} was removed together with "
                             f"its Pallas kernel; use one of "
                             f"{IMPL_CHOICES[key]}")
    for key, choices in IMPL_CHOICES.items():
        if key in impl and impl[key] not in choices:
            raise ValueError(f"tpu.{key}={impl[key]!r} is not one of {choices}")
    return config


def sanitize_config(config, imshape):
    """Validate the configuration tree against the input image shape."""
    check_impl_options(config)
    if config.mode == "grey" and config.grey_method != "FFT":
        raise NotImplementedError("Grey level images should be obtained with FFT")

    assert config.scale >= 1

    ard = config.accumulated_robustness_denoiser
    if not config.robustness.enabled and (ard.median.enabled or ard.gauss.enabled
                                          or ard.merge.enabled):
        raise ValueError("Accumulated robustness denoiser cannot be enabled if "
                         "robustness is disabled.")
    if not config.robustness.enabled and config.robustness.save_mask:
        raise ValueError("Robustness mask cannot be saved if robustness is disabled.")

    assert config.merging.kernel in ("steerable", "iso"), \
        f"Unknown kernel type {config.merging.kernel}"
    assert config.mode in ("bayer", "grey"), f"Unknown mode {config.mode}"

    if sum(1 for x in (ard.median, ard.gauss, ard.merge) if x.enabled) > 1:
        raise ValueError("Only one accumulated robustness denoiser can be enabled "
                         "at a time.")

    assert config.ica.tuning.n_iter > 0, "Number of ICA iterations should be positive."
    assert config.ica.tuning.sigma_blur >= 0, \
        f"Invalid sigma blur {config.ica.tuning.sigma_blur}."

    assert len(imshape) == 2, f"Input image shape should be 2D, got {imshape}."

    bm = config.block_matching.tuning
    Ts = bm.tile_size

    # Checking that every pyramid level can hold at least one tile. The
    # alignment runs on the grey image, which is half-resolution when
    # grey_method == "decimating" (bayer mode).
    grey_shape = imshape
    if config.mode == "bayer" and config.get("grey_method", "FFT") == "decimating":
        grey_shape = (imshape[0] // 2, imshape[1] // 2)
    padded_y = Ts * int(np.ceil(grey_shape[0] / Ts))
    padded_x = Ts * int(np.ceil(grey_shape[1] / Ts))
    lvl_y, lvl_x = padded_y, padded_x
    for lvl, (factor, ts) in enumerate(zip(bm.factors, bm.tile_sizes)):
        lvl_y, lvl_x = np.floor(lvl_y / factor), np.floor(lvl_x / factor)
        if lvl_y / ts < 1 or lvl_x / ts < 1:
            raise ValueError(
                "Image of shape {} is incompatible with the given block matching "
                "tile sizes and factors : at level {}, coarse image of shape {} "
                "cannot be divided into tiles of size {}.".format(
                    imshape, lvl, (lvl_y, lvl_x), ts))

    valid_upsample_modes = ("nearest", "bilinear", "bicubic")
    assert bm.flow_upscale_mode in valid_upsample_modes, (
        f"Unknown flow upscaling mode {bm.flow_upscale_mode}, should be one of "
        f"{valid_upsample_modes}.")

    return config
