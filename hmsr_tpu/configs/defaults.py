"""Default configuration — same knobs and defaults as the reference
(reference configs/default.yaml), plus implementation switches under ``tpu``.

Kept as a Python structure so that ``default_config()`` needs no YAML parser;
PyYAML is needed only to read or write a user's YAML file.
"""

DEFAULTS = {
    "scale": 1,
    "mode": "bayer",            # bayer | grey
    "debug": False,
    "verbose": 1,
    "grey_method": "FFT",       # FFT | decimating
    "noise_model": {
        "alpha": None,
        "beta": None,
    },
    "block_matching": {
        "tuning": {
            # Defined fine-to-coarse
            "factors": [1, 2, 4, 4],
            "tile_size": "SNR_based",
            "tile_size_factors": [1, 1, 1, 0.5],
            "search_radii": [1, 4, 4, 4],
            "metrics": ["L1", "L2", "L2", "L2"],
            "flow_upscale_mode": "nearest",   # nearest | bilinear | bicubic
        },
    },
    "ica": {
        "tuning": {
            "n_iter": 3,
            "sigma_blur": 0,
        },
    },
    "robustness": {
        "enabled": True,
        "save_mask": True,
        "tuning": {
            "t": 0.12,
            "s1": 2,
            "s2": 12,
            "Mt": 0.8,
        },
    },
    "merging": {
        "kernel": "steerable",          # steerable | iso
        "selection_law": "linear",      # hard_threshold | linear
        "tuning": {
            "k_detail": "SNR_based",
            "k_denoise": "SNR_based",
            "D_th": "SNR_based",
            "D_tr": "SNR_based",
            "k_stretch": 4,
            "k_shrink": 2,
        },
    },
    "postprocessing": {
        "enabled": True,
        "do_color_correction": False,
        "do_gamma_correction": True,
        "do_tonemapping": False,
        "sharpening": {
            "enabled": True,
            "amount": 1.5,
            "radius": 3,
        },
        "do_devignetting": False,
    },
    "accumulated_robustness_denoiser": {
        "median": {
            "enabled": False,
            "radius_max": 3,
            "max_frame_count": 8,
        },
        "gauss": {
            "enabled": False,
            "sigma_max": 1.5,
            "max_frame_count": 8,
        },
        "merge": {
            "enabled": False,
            "rad_max": 2,
            "max_multiplier": 8,    # covariance multiplier for single-frame SR
            "max_frame_count": 2,   # merged frames above which no blur is applied
        },
    },
    # Implementation switches (no equivalent in the reference). Each "auto"
    # resolves to one fixed implementation; the others are kept as explicit
    # options and as test references.
    "tpu": {
        # L2 block-matching correlation: "direct" multiply-reduce
        # (mathematically identical to the reference FFT correlation) or
        # "fft" (jnp.fft, like the reference torch path).
        "correlation": "direct",
        # Per-frame merge: "auto" = the tile-restructured fast path for
        # integer scales and the exact reference-layout gather path
        # otherwise.
        "merge_impl": "auto",          # auto | tiled | gather
        # Robustness upscale-warp: "auto" = tiled (gather-free).
        "robustness_impl": "auto",     # auto | gather
        # ICA warp: "auto" = tiled (gather-free dynamic-slice windows).
        "ica_impl": "auto",            # auto | gather
        # FFT-grey backend: "auto" = jnp.fft; "matmul" (circulant) and "ct"
        # (Cooley-Tukey) evaluate the identical spectral low-pass as matmuls.
        "grey_impl": "auto",           # auto | fft | matmul | ct
        # Pipeline structure: "fused" = analysis scan + burst-fused slab
        # merge (the integer-scale default); "scan" = per-frame merge in the
        # frame scan (the fractional-scale default); "vmapped" = vmapped
        # analysis + merge-only scan.
        "pipeline": "auto",            # auto | scan | fused | vmapped
        # Finishing ISP placement: "device" runs the jnp port of the
        # postprocess chain (finishing/device.py) on the accelerator; "host"
        # keeps the NumPy/scipy chain. "auto" = device unless cv2-Mertens
        # tonemapping is requested AND cv2 is importable (Mertens stays on
        # the host, like the reference's OpenCV call).
        "finishing_impl": "auto",      # auto | device | host
        # Profiling knobs: truncate alignment after k pyramid levels
        # (align_levels) / the robustness chain after k sub-stages
        # (rob_trunc). Unset = full. Setting either raises unless
        # HMSR_DEBUG_TRUNC=1 (truncated output is meaningless; the guard
        # stops accidental production use).
    },
}
