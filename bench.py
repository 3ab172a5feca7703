#!/usr/bin/env python
"""Benchmark: 20-frame raw burst -> x2 super-resolution wall-clock.

Prints ONE JSON line to stdout:
    {"metric": ..., "value": <seconds>, "unit": "s", "vs_baseline": <x>}

Baseline: the reference processes a 20x12MP burst in < 4 s on an RTX 3090
(reference README.md:10, BASELINE.md); ``vs_baseline`` is the speedup factor
(reference seconds for the same pixel count) / ours.

Methodology:
- timing excludes compilation (reference excludes Numba JIT warmup too);
- each timed run uses slightly perturbed inputs and ends in a readback of an
  in-graph checksum scalar;
- the target size is tried first and a smaller one only if it fails; the
  size measured is reported.

``chip_smoke.py`` is the bring-up check of the same programs on the GPU;
turning this script into the GPU benchmark is ROADMAP S1.
"""

import json
import sys
import time

import numpy as np

BASELINE_S = 4.0           # reference: 20x12MP in <4s on RTX 3090
BASELINE_MPIX = 12.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_burst(h, w, n_frames, alpha, beta, seed=0, brightness=None):
    """Synthetic raw burst with SUB-PIXEL handheld shifts (honest benchmark:
    integer shifts let block matching recover exact flow with ICA fractions
    ~0, putting every group-DMA fast path permanently on its best case).
    Spectral (exact) sub-pixel shifts of a bandlimited scene + per-frame
    affine noise. ``brightness`` scales the scene: ~0.5 -> SNR ~ 50 (Ts=16),
    ~0.02 -> low light (Ts=32/64 paths).

    The result is disk-cached in the temporary directory: generation costs
    minutes of host CPU at 12MP (20 float64 spectral shifts on one core) and
    is deterministic in the arguments."""
    import os
    import tempfile
    cache = os.path.join(
        tempfile.gettempdir(), f"hmsr_burst_{h}x{w}_n{n_frames}_a{alpha}"
        f"_b{beta}_s{seed}_br{brightness}.npy")
    if os.path.exists(cache):
        try:
            return np.load(cache)
        except Exception:
            pass
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 16 + 1, w // 16 + 1).astype(np.float32)
    img = np.kron(base, np.ones((16, 16), np.float32))[:h, :w]
    try:
        from scipy.ndimage import gaussian_filter
        img = gaussian_filter(img, 4.0)
    except ImportError:
        pass
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    lo, hi = (0.1, 0.9) if brightness is None else \
        (0.2 * brightness, 1.8 * brightness)
    img = lo + (hi - lo) * img

    fy = np.fft.fftfreq(h)[:, None].astype(np.float64)
    fx = np.fft.fftfreq(w)[None, :].astype(np.float64)
    spec = np.fft.fft2(img.astype(np.float64))

    frames = np.empty((n_frames, h, w), np.float32)
    for n in range(n_frames):
        dy, dx = (0.0, 0.0) if n == 0 else rng.uniform(-3, 3, 2)
        phase = np.exp(-2j * np.pi * (fy * dy + fx * dx))
        shifted = np.real(np.fft.ifft2(spec * phase)).astype(np.float32)
        noise = np.sqrt(np.maximum(alpha * shifted + beta, 0)) * \
            rng.randn(h, w).astype(np.float32)
        frames[n] = np.clip(shifted + noise, 0, 1)
    try:
        np.save(cache, frames)
    except Exception:
        pass
    return frames


def bench_size(h, w, n_frames, std_curve, diff_curve, n_runs=3,
               brightness=None, tag="", mutate=None):
    import jax
    import jax.numpy as jnp
    from hmsr_tpu.configs import default_config, update_snr_config, sanitize_config
    from hmsr_tpu.models.pipeline import make_pipeline

    ALPHA, BETA = 1.8e-4, 3.0e-6
    CFA = np.array([[0, 1], [1, 2]])

    frames = make_burst(h, w, n_frames, ALPHA, BETA, brightness=brightness)
    import os
    config = default_config()
    config.scale = 2
    config.verbose = 0
    config.noise_model.alpha = ALPHA
    config.noise_model.beta = BETA
    config.accumulated_robustness_denoiser.enabled = False
    if os.environ.get("HMSR_PIPELINE"):
        config.tpu.pipeline = os.environ["HMSR_PIPELINE"]
    if os.environ.get("HMSR_MERGE_IMPL"):
        config.tpu.merge_impl = os.environ["HMSR_MERGE_IMPL"]

    mean_b = float(frames[0].mean())
    snr = mean_b / std_curve[int(round(1000 * mean_b))]
    update_snr_config(config, snr)
    if mutate is not None:
        mutate(config)                    # BASELINE.json variant overrides
    sanitize_config(config, frames[0].shape)
    log(f"[{h}x{w}{tag}] SNR={snr:.1f} -> Ts={config.block_matching.tuning.tile_size}"
        f" scale={config.scale} mode={config.mode}")

    pipe = make_pipeline(config, CFA, [1.0, 1.0, 1.0], jit=False)
    # matmul-grey circulants (None on the default FFT path) fed through the
    # jit boundary as ARGUMENTS — see grey.grey_matmul_consts
    from hmsr_tpu.ops.grey import grey_consts_for
    gc = grey_consts_for(config, frames[0].shape)

    def run_with_checksum(ref, comps, std, diff, gc):
        img, _ = pipe(ref, comps, std, diff, grey_consts=gc)
        sub = img[::31, ::37]                  # (H*s, W*s, c) sampled
        # border pixels with zero accumulated weight are NaN (the reference
        # nan_to_nums at the CLI); keep the checksum finite
        return jnp.sum(jnp.where(jnp.isfinite(sub), sub, 0.0))

    fn = jax.jit(run_with_checksum)
    ref_d = jnp.asarray(frames[0])
    comps_d = jnp.asarray(frames[1:])
    std_d = jnp.asarray(std_curve.astype(np.float32))
    diff_d = jnp.asarray(diff_curve.astype(np.float32))

    log(f"[{h}x{w}{tag} x{n_frames}] compiling ...")
    t0 = time.perf_counter()
    v = float(np.asarray(fn(ref_d, comps_d, std_d, diff_d, gc)))
    log(f"[{h}x{w}{tag} x{n_frames}] compile+run {time.perf_counter()-t0:.1f}s "
        f"checksum={v:.3f}")
    assert np.isfinite(v)

    times = []
    for i in range(n_runs):
        comps_i = comps_d + jnp.float32(1e-7 * (i + 1))
        _ = float(np.asarray(jnp.sum(comps_i[0, ::512, ::512])))  # settle input
        t0 = time.perf_counter()
        v = float(np.asarray(fn(ref_d, comps_i, std_d, diff_d, gc)))
        times.append(time.perf_counter() - t0)
        log(f"[{h}x{w}{tag} x{n_frames}] run {i}: {times[-1]:.3f}s checksum={v:.3f}")
    return min(times)


def bench_finishing(h, w, n_runs=3):
    """Time the device finishing ISP at the SR output size (2h, 2w, 3).

    The reference's < 4 s covers its whole ``process()`` including the host
    postprocess (super_resolution.py:331-343, raw2rgb.py:212-250); the
    headline here times only the jitted device pipeline, so the finishing
    chain (default config: sharpening + gamma — finishing/device.py) is
    measured separately and reported as ``finishing_value`` /
    ``incl_finishing_value`` (VERDICT r03 weak #8)."""
    import jax
    import jax.numpy as jnp
    from hmsr_tpu.finishing.device import make_postprocess_device

    sh, sw = 2 * h, 2 * w
    fin = make_postprocess_device(
        do_color_correction=False, do_tonemapping=False, do_gamma=True,
        sharpening_config={"enabled": True, "amount": 1.5, "radius": 3})

    def run(img):
        out = fin(img)
        sub = out[::31, ::37]
        return jnp.sum(sub)

    fn = jax.jit(run)
    rng = np.random.RandomState(1)
    img = jnp.asarray(rng.rand(sh, sw, 3).astype(np.float32))
    t0 = time.perf_counter()
    v = float(np.asarray(fn(img)))
    log(f"[finishing {sh}x{sw}x3] compile+run {time.perf_counter()-t0:.1f}s "
        f"checksum={v:.3f}")
    times = []
    for i in range(n_runs):
        img_i = img + jnp.float32(1e-7 * (i + 1))
        _ = float(np.asarray(jnp.sum(img_i[::512, ::512, 0])))
        t0 = time.perf_counter()
        v = float(np.asarray(fn(img_i)))
        times.append(time.perf_counter() - t0)
        log(f"[finishing {sh}x{sw}x3] run {i}: {times[-1]:.3f}s "
            f"checksum={v:.3f}")
    return min(times)


def emit(state):
    """Print the current result JSON line (superseding any earlier line).

    The driver killed round 3's bench at its timeout BEFORE the single
    end-of-run print — leaving rc=124 / parsed=null despite a finished 12MP
    measurement. Now a full JSON line is (re-)emitted after EVERY completed
    variant, each superseding the last, so a timeout at any point still
    leaves the latest complete result parseable on stdout."""
    if state.get("value") is None:
        out = {"metric": "e2e_burst_x2SR_wallclock", "value": -1,
               "unit": "s", "vs_baseline": 0}
    else:
        mpix = state["mpix"]
        baseline = BASELINE_S * mpix / BASELINE_MPIX
        out = {
            "metric": f"e2e_{state['n_frames']}x{mpix:g}MP_burst_x2SR_wallclock",
            "value": round(state["value"], 4),
            "unit": "s",
            "vs_baseline": round(baseline / state["value"], 3),
        }
        for key in ("dark_value", "dark64_value", "finishing_value",
                    "x1_value", "x3_value", "grey_value"):
            if key in state:
                out[key] = round(state[key], 4)
        if "finishing_value" in state:
            out["incl_finishing_value"] = round(
                state["value"] + state["finishing_value"], 4)
    pending = state.get("pending", [])
    if pending:
        out["pending_variants"] = list(pending)
    if state.get("failed"):
        out["failed_variants"] = state["failed"]
    print(json.dumps(out), flush=True)


def main():
    import signal

    import jax  # noqa: F401  (fail early if backend is broken)
    from hmsr_tpu.noise import run_fast_MC
    from hmsr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    ALPHA, BETA = 1.8e-4, 3.0e-6
    N_FRAMES = 20

    # If a timeout SIGTERMs us mid-variant, still flush the best result so
    # far (the handler can't interrupt a blocked compile, but it covers
    # every point where Python bytecode runs).
    state = {"failed": [], "n_frames": N_FRAMES,
             "pending": ["bright", "finishing", "dark", "dark64",
                         "x1", "x3", "grey"]}

    def on_term(signum, frame):
        log("SIGTERM — emitting best-so-far result")
        state.setdefault("failed", []).append(
            {"variant": "timeout", "error": "SIGTERM during " +
             (state["pending"][0] if state["pending"] else "teardown")})
        emit(state)
        sys.exit(1)

    signal.signal(signal.SIGTERM, on_term)

    log("calibrating noise curves ...")
    t0 = time.perf_counter()
    std_curve, diff_curve = run_fast_MC(ALPHA, BETA)
    log(f"noise curves: {time.perf_counter()-t0:.1f}s")

    # Target size first; the small size is only a fallback so a fault at
    # 12MP still leaves a measured number.
    for h, w in [(3000, 4000), (1500, 2000)]:
        try:
            state["value"] = bench_size(h, w, N_FRAMES, std_curve, diff_curve)
            state["mpix"] = h * w / 1e6
            break
        except Exception as e:
            log(f"[{h}x{w}] FAILED: {type(e).__name__}: {e}")
            state["failed"].append({"variant": f"bright_{h}x{w}",
                                    "error": f"{type(e).__name__}: {e}"[:300]})

    state["pending"].remove("bright")
    emit(state)
    if state.get("value") is None:
        sys.exit(1)

    # finishing ISP at the SR output size (process()-inclusive reporting)
    try:
        state["finishing_value"] = bench_finishing(h, w)
    except Exception as e:
        log(f"[finishing] FAILED: {type(e).__name__}: {e}")
        state["failed"].append({"variant": "finishing",
                                "error": f"{type(e).__name__}: {e}"[:300]})
    state["pending"].remove("finishing")
    emit(state)

    # low-light variants (SNR-adaptive Ts=32/64 paths) at the same size —
    # reported alongside, never replacing the headline. A variant failure is
    # NEVER silent: it lands in failed_variants and flips the exit code
    # (the r02 dark crash sailed through rc=0).
    for key, brightness, tag in [("dark_value", 0.07, " dark"),
                                 ("dark64_value", 0.02, " dark64")]:
        try:
            state[key] = bench_size(h, w, N_FRAMES, std_curve, diff_curve,
                                    brightness=brightness, tag=tag)
        except Exception as e:
            log(f"[{h}x{w}{tag}] FAILED: {type(e).__name__}: {e}")
            state["failed"].append({"variant": tag.strip(),
                                    "error": f"{type(e).__name__}: {e}"[:300]})
        state["pending"].remove(tag.strip())
        emit(state)

    # remaining BASELINE.json configs at size (VERDICT r04 weak #4):
    # x1 merge (robustness off), x3 scale + accumulated-robustness
    # weighting, grey (non-Bayer) mode — ordered after the headline
    # variants so a driver timeout costs only the tail.
    def mut_x1(c):
        c.scale = 1
        c.robustness.enabled = False
        c.robustness.save_mask = False

    def mut_x3(c):
        c.scale = 3
        c.accumulated_robustness_denoiser.enabled = True

    def mut_grey(c):
        c.mode = "grey"

    for key, mutate, tag in [("x1_value", mut_x1, " x1"),
                             ("x3_value", mut_x3, " x3"),
                             ("grey_value", mut_grey, " grey")]:
        try:
            state[key] = bench_size(h, w, N_FRAMES, std_curve, diff_curve,
                                    tag=tag, mutate=mutate)
        except Exception as e:
            log(f"[{h}x{w}{tag}] FAILED: {type(e).__name__}: {e}")
            state["failed"].append({"variant": tag.strip(),
                                    "error": f"{type(e).__name__}: {e}"[:300]})
        state["pending"].remove(tag.strip())
        emit(state)

    if state["failed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
