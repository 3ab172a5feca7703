"""Public API: ``process(burst_path, config)`` — host orchestration.

Rebuild of reference super_resolution.py:203-360: burst ingestion, noise
model selection, on-the-fly noise-curve calibration, SNR-adaptive
hyperparameters, the jitted device pipeline, optional frame-count denoising,
finishing ISP, and EXIF orientation.
"""

import time

import numpy as np
import jax.numpy as jnp

from ..configs import default_config, merge as merge_config, sanitize_config, \
    update_snr_config
from ..finishing import (apply_orientation, frame_count_denoising_gauss,
                         frame_count_denoising_median, postprocess)
from ..io.burst import load_burst
from ..noise import run_fast_MC
from ..utils.timing import getTime, timer
from ..utils.types import DEFAULT_NUMPY_FLOAT
from .pipeline import make_pipeline


def process(burst_path, config=None):
    """Process a raw burst folder / bundle into an RGB image.

    Returns ``(output_image, debug_dict)`` like the reference API.
    """
    if config is None:
        config = default_config()
    burst = load_burst(burst_path, mode=config.mode)
    return process_burst(burst, config)


def process_arrays(ref_raw, comp_raws, config=None, cfa=None,
                   white_balance=None, xyz2cam=None, orientation=1, iso=100):
    """Process an already-loaded burst of raw arrays."""
    from ..io.burst import Burst
    if config is None:
        config = default_config()
    if cfa is None:
        cfa = np.array([[0, 1], [1, 2]])
    if white_balance is None:
        white_balance = [1.0, 1.0, 1.0]
    burst = Burst(ref_raw=np.asarray(ref_raw, DEFAULT_NUMPY_FLOAT),
                  comp_raws=np.asarray(comp_raws, DEFAULT_NUMPY_FLOAT),
                  iso=iso, cfa=np.asarray(cfa), xyz2cam=xyz2cam,
                  white_balance=list(white_balance), noise_alpha=None,
                  noise_beta=None, orientation=orientation, ref_path=None)
    return process_burst(burst, config)


def _trace_stages(burst, std_curve, diff_curve, config):
    """verbose>=3: per-stage device trace on the FIRST comp frame.

    Analogue of the reference's verbose_3 per-stage prints
    (super_resolution.py:72-81): each stage runs as its own dispatch with a
    ``block_until_ready`` barrier, so the numbers include per-dispatch
    overhead that the single-program pipeline does not pay — treat them as
    relative weights, not a budget.
    """
    import jax
    from .alignment import align, init_alignment
    from .kernels import estimate_kernels
    from .pipeline import select_merge, flow_to_raw_grid
    from .robustness import compute_robustness, init_robustness
    from ..ops.grey import compute_grey_image
    from ..utils.types import DEFAULT_FLOAT

    bayer = config.mode == "bayer"
    grey_method = str(config.get("grey_method", "FFT"))
    ref = jnp.asarray(burst.ref_raw, DEFAULT_FLOAT)
    frame = jnp.asarray(burst.comp_raws[0], DEFAULT_FLOAT)
    curves = (jnp.asarray(std_curve, DEFAULT_NUMPY_FLOAT),
              jnp.asarray(diff_curve, DEFAULT_NUMPY_FLOAT))
    cfa, wb = burst.cfa, burst.white_balance
    grey_impl = str(config.get("tpu", {}).get("grey_impl", "auto"))
    grey_fn = jax.jit(lambda f: compute_grey_image(f, grey_method,
                                                   impl=grey_impl)
                      if bayer else f)

    print(" -- Stage trace (first frame, incl. dispatch overhead):")
    t0 = time.perf_counter()
    ref_grey = jax.block_until_ready(grey_fn(ref))
    astate = jax.block_until_ready(
        jax.jit(lambda g: init_alignment(g, config))(ref_grey))
    rstats = jax.block_until_ready(jax.jit(
        lambda i: init_robustness(i, cfa, wb, curves, config))(ref))
    t0 = getTime(t0, " --- Ref init (grey+pyramid+stats)")
    grey = jax.block_until_ready(grey_fn(frame))
    t0 = getTime(t0, " --- Grey conversion")
    flow = jax.block_until_ready(
        jax.jit(lambda g: align(astate, g, config))(grey))
    t0 = getTime(t0, " --- Alignment (BM + ICA)")
    if bayer and grey_method == "decimating":
        flow = flow_to_raw_grid(flow, frame.shape,
                                int(config.block_matching.tuning.tile_size))
    r = jax.block_until_ready(jax.jit(
        lambda f, fl: compute_robustness(f, rstats, fl, cfa, wb, config))(
            frame, flow))
    t0 = getTime(t0, " --- Robustness")
    covs = jax.block_until_ready(
        jax.jit(lambda f: estimate_kernels(f, config))(frame))
    t0 = getTime(t0, " --- Kernel estimation")
    h, w = frame.shape
    out_h, out_w = round(config.scale * h), round(config.scale * w)
    n_ch = 3 if bayer else 1
    merge_fn = select_merge(config)
    num = jnp.zeros((n_ch, out_h, out_w), DEFAULT_FLOAT)
    den = jnp.zeros((n_ch, out_h, out_w), DEFAULT_FLOAT)
    jax.block_until_ready(jax.jit(
        lambda *a: merge_fn(*a, cfa, config))(frame, flow, covs, r, num, den))
    getTime(t0, " --- Merge (one frame)")


def _try_iso_curves(burst, config, load_noise_curves):
    """Look for ISO-keyed curves in (in order): ``config.noise_model.data_dir``,
    ``./data`` and the repo-root ``data/`` next to the package."""
    import os
    if burst.iso is None:
        return None, None
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [config.noise_model.get("data_dir", None), "data",
                  os.path.join(here, "data")]
    for d in candidates:
        if not d:
            continue
        try:
            std, diff = load_noise_curves(burst.iso, d)
            return (np.asarray(std, DEFAULT_NUMPY_FLOAT),
                    np.asarray(diff, DEFAULT_NUMPY_FLOAT))
        except (OSError, ValueError):
            continue
    return None, None


def process_burst(burst, config):
    t0 = time.perf_counter()
    verbose_1 = config.verbose >= 1
    verbose_2 = config.verbose >= 2

    # ---- noise model: user-provided > EXIF noise profile > ISO-keyed curves
    std_curve = diff_curve = None
    if config.noise_model.get("alpha", None) is not None:
        if verbose_1:
            print("Using user provided alpha and beta values")
        alpha = config.noise_model.alpha
        beta = config.noise_model.beta
    elif burst.noise_alpha is not None:
        alpha = burst.noise_alpha
        beta = burst.noise_beta
    else:
        # the reference's intended ISO-keyed loading path
        # (super_resolution.py:243-251, commented out there): round the
        # burst ISO to a standard value and load pre-generated curves.
        from ..noise import load_noise_curves
        from ..noise.fast_monte_carlo import fit_alpha_beta
        std_curve, diff_curve = _try_iso_curves(burst, config, load_noise_curves)
        if std_curve is None:
            raise ValueError(
                "No noise model available: provide noise_model.alpha/beta in "
                "the config, use DNGs/bundles carrying a noise profile tag, "
                "or ship ISO-keyed curves (noise_model.data_dir, "
                "tools/generate_noise_curves.py).")
        if verbose_1:
            print(f"Using ISO-keyed noise curves (ISO {burst.iso})")
        alpha, beta = fit_alpha_beta(std_curve)
    config.noise_model.update({"alpha": float(alpha), "beta": float(beta)})

    # ---- on-the-fly noise-curve calibration (cached per alpha/beta)
    if std_curve is None:
        std_curve, diff_curve = run_fast_MC(alpha, beta)
    if verbose_2:
        t0 = getTime(t0, " -- Read raw files & noise curves")

    # ---- SNR-adaptive hyperparameters
    brightness = float(np.mean(burst.ref_raw))
    id_noise = int(round(1000 * brightness))
    std = std_curve[np.clip(id_noise, 0, len(std_curve) - 1)]
    SNR = brightness / std
    if verbose_1:
        print(" ", 10 * "-")
        print(f"|ISO : {burst.iso}")
        print(f"|Image brightness : {brightness:.2f}")
        print(f"|expected noise std : {std:.2e}")
        print(f"|Estimated SNR : {SNR:.2f}")

    update_snr_config(config, SNR)
    sanitize_config(config, burst.ref_raw.shape)

    ard = config.accumulated_robustness_denoiser
    ard.enabled = bool(ard.median.enabled or ard.gauss.enabled or ard.merge.enabled)

    # ---- optional jax profiler capture around the device pipeline
    profile_dir = config.get("tpu", {}).get("profile_dir", None)
    prof_ctx = None
    if profile_dir:
        import jax.profiler
        prof_ctx = jax.profiler.trace(profile_dir)
        prof_ctx.__enter__()

    # ---- the jitted device pipeline (sharded across devices if configured)
    mesh_shape = config.get("tpu", {}).get("mesh", None)
    if mesh_shape and int(mesh_shape[0]) * int(mesh_shape[1]) > 1:
        import jax
        from ..parallel import make_mesh, make_sharded_pipeline, pad_frames
        nf, ns = int(mesh_shape[0]), int(mesh_shape[1])
        assert len(jax.devices()) >= nf * ns, \
            f"mesh {mesh_shape} needs {nf * ns} devices, have {len(jax.devices())}"
        mesh = make_mesh(nf, ns)
        pipe = make_sharded_pipeline(config, burst.cfa, burst.white_balance,
                                     mesh)
        frames, weights = pad_frames(burst.comp_raws, nf)
        outs = pipe(jnp.asarray(burst.ref_raw), jnp.asarray(frames),
                    jnp.asarray(weights),
                    jnp.asarray(std_curve, DEFAULT_NUMPY_FLOAT),
                    jnp.asarray(diff_curve, DEFAULT_NUMPY_FLOAT))
        image, acc_r = outs[0], outs[1]
        debug = {"accumulated_robustness": acc_r} \
            if (ard.enabled or config.robustness.save_mask) else {}
        if config.debug:
            n = burst.comp_raws.shape[0]     # drop zero-weight padding frames
            debug["flow"] = outs[2][:n]
            debug["robustness"] = outs[3][:n]
    else:
        if config.verbose >= 3:
            _trace_stages(burst, std_curve, diff_curve, config)
        pipe = make_pipeline(config, burst.cfa, burst.white_balance)
        pipe = timer(pipe, verbose_2, end_s=" -- Device pipeline (align+merge)")
        image, debug = pipe(jnp.asarray(burst.ref_raw),
                            jnp.asarray(burst.comp_raws),
                            jnp.asarray(std_curve, DEFAULT_NUMPY_FLOAT),
                            jnp.asarray(diff_curve, DEFAULT_NUMPY_FLOAT))

    if prof_ctx is not None:
        import jax
        jax.block_until_ready(image)
        prof_ctx.__exit__(None, None, None)

    # ---- frame-count-aware post denoising
    median_cfg = ard.median
    gauss_cfg = ard.gauss
    if median_cfg.enabled or gauss_cfg.enabled:
        if verbose_1:
            print("-- Robustness aware bluring")
        acc_r = debug["accumulated_robustness"]
        t_dn = time.perf_counter()
        if median_cfg.enabled:
            mc = median_cfg.copy()
            mc["scale"] = config.scale
            image = frame_count_denoising_median(image, acc_r, mc)
        if gauss_cfg.enabled:
            gc = gauss_cfg.copy()
            gc["scale"] = config.scale
            image = frame_count_denoising_gauss(image, acc_r, gc)
        if verbose_2:
            import jax
            jax.block_until_ready(image)
            getTime(t_dn, " -- Frame-count denoising")

    # ---- finishing ISP
    # auto = device (jnp) chain whenever the cv2-Mertens exposure fusion is
    # not requested (the chain is then a numerics-parity port —
    # finishing/device.py); Mertens itself stays on the host like the
    # reference's OpenCV call (raw2rgb.py:153-170), so do_tonemapping + cv2
    # routes the whole chain through the host path.
    pp = config.postprocessing
    if pp.enabled:
        finishing_impl = config.get("tpu", {}).get("finishing_impl", "auto")
        needs_mertens = False
        if pp.do_tonemapping and finishing_impl != "device":
            try:
                import cv2  # noqa: F401
                needs_mertens = True
            except ImportError:
                pass
        use_device = finishing_impl == "device" or \
            (finishing_impl == "auto" and not needs_mertens)
        if verbose_2:
            print(f"-- Post processing image ({'device' if use_device else 'host'})")
        t_pp = time.perf_counter()
        if use_device:
            from ..finishing.device import make_postprocess_device
            import jax
            rgb = jnp.repeat(image, 3, axis=-1) \
                if image.shape[-1] == 1 else jnp.asarray(image)
            fin = jax.jit(make_postprocess_device(
                do_color_correction=pp.do_color_correction,
                do_tonemapping=pp.do_tonemapping,
                do_gamma=pp.do_gamma_correction,
                sharpening_config=pp.sharpening,
                do_devignette=pp.do_devignetting,
                xyz2cam=burst.xyz2cam))
            image = np.asarray(fin(rgb))
        else:
            image = np.asarray(image)
            rgb = np.repeat(image, 3, axis=-1) \
                if image.shape[-1] == 1 else image
            image = postprocess(rgb,
                                do_color_correction=pp.do_color_correction,
                                do_tonemapping=pp.do_tonemapping,
                                do_gamma=pp.do_gamma_correction,
                                sharpening_config=pp.sharpening,
                                do_devignette=pp.do_devignetting,
                                xyz2cam=burst.xyz2cam)
        if verbose_2:
            getTime(t_pp, " -- Finishing ISP")
    else:
        image = np.asarray(image)

    image = apply_orientation(image, burst.orientation)
    out_debug = {k: np.asarray(v) for k, v in debug.items()}
    if "accumulated_robustness" in out_debug:
        out_debug["accumulated_robustness"] = apply_orientation(
            out_debug["accumulated_robustness"], burst.orientation)

    if verbose_1:
        s = "\nTotal ellapsed time : "
        print(s, " " * (50 - len(s)), ": ", round(time.perf_counter() - t0, 2),
              "seconds")
    return image, out_debug
