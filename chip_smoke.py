#!/usr/bin/env python
"""Bring-up check of the burst pipeline on one NVIDIA GPU.

Usage:
    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --devices 4  # phase 1 and phase 6 only, on 4 GPUs
    python chip_smoke.py --json-out findings.json  # also write every finding

Phases (one process holds the card for the whole run):

1. device     -- platform, device kind and count, and the card's name and
                 power limit from ``nvidia-smi`` (a subprocess, off JAX);
2. main path  -- ``process_arrays`` twice on a seeded 20-frame 3000x4000
                 RGGB burst generated on the device: default config, x2,
                 robustness and device finishing on;
3. variants   -- each program of ``bench.py`` (bright Ts=16, dark Ts=32,
                 dark64 Ts=64, x1, x3 with accumulated robustness, grey)
                 compiled and run once through ``make_pipeline`` at full
                 size;
4. parity     -- the default program on the GPU and on the CPU in this
                 process, at three tile-size tiers, under the e2e gates;
5. fast paths -- each XLA fast path against the repo's plain reference on
                 one full-size frame of the main-path burst;
6. sharded    -- (``--devices N`` only) ``make_sharded_pipeline`` over two
                 meshes against the one-card ``scan`` pipeline.

Every phase is a function of a device (or devices) and sizes, so the tests
rehearse them on the CPU at tiny sizes. A phase that fails raises; the script
then exits non-zero without the final line. The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any phase.
"""

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np

ALPHA, BETA = 1.8e-4, 3.0e-6
CFA = np.array([[0, 1], [1, 2]])
WB = [1.0, 1.0, 1.0]
FULL_SIZE = (3000, 4000)
N_FRAMES = 20
#: e2e parity tiers (name, image side, tile size) and gates
PARITY_TIERS = (("ts16", 128, 16), ("ts32", 256, 32), ("ts64", 512, 64))
PARITY_GATES = {"flow_max": 1e-2, "img_mean": 1e-4, "img_max": 1e-3}
#: bench.py's programs (brightness and config mutation: phase_variants)
VARIANTS = ("bright", "dark", "dark64", "x1", "x3", "grey")


def log(tag, **fields):
    """One finding per line: ``[tag] key=value ...``."""
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{tag}] {parts}", flush=True)


class CompileCounter:
    """Counts backend compiles (persistent-cache hits included) while
    active."""

    _active = []

    def __init__(self):
        self.compiles = 0
        self.compile_s = 0.0
        self.cache_hits = 0

    @classmethod
    def _install(cls):
        if getattr(cls, "_installed", False):
            return
        import jax.monitoring as mon

        def on_duration(event, secs, **_):
            for c in cls._active:
                if event == "/jax/core/compile/backend_compile_duration":
                    c.compiles += 1
                    c.compile_s += secs

        def on_event(event, **_):
            for c in cls._active:
                if event == "/jax/compilation_cache/cache_hits":
                    c.cache_hits += 1

        mon.register_event_duration_secs_listener(on_duration)
        mon.register_event_listener(on_event)
        cls._installed = True

    def __enter__(self):
        self._install()
        self._active.append(self)
        return self

    def __exit__(self, *exc):
        self._active.remove(self)

    def fields(self):
        return {"compiles": self.compiles,
                "compile_s": round(self.compile_s, 3),
                "cache_hits": self.cache_hits}


def analytic_curves(alpha=ALPHA, beta=BETA):
    """Analytic affine-model curves (the parity tiers' own, as in tests)."""
    b = np.arange(1001) / 1000.0
    std = np.sqrt(np.maximum(alpha * b + beta, 0)).astype(np.float32)
    diff = np.sqrt(2 / np.pi * 2 * (alpha * b + beta) / 9).astype(np.float32)
    return std, diff


def make_burst(device, h, w, n_frames, seed=0, brightness=None,
               alpha=ALPHA, beta=BETA, max_shift=3.0):
    """Seeded raw burst generated on ``device``; returns (n, h, w) float32.

    Same scene model as ``bench.make_burst``: 16-px random blocks blurred by
    a Gaussian (sigma 4, applied in the Fourier domain, so circular),
    brightness range [0.1, 0.9] (or [0.2, 1.8] x ``brightness``), exact
    sub-pixel shifts as Fourier phase ramps (frame 0 unshifted), and
    per-pixel affine noise ``std^2 = alpha * I + beta``.
    """
    import jax
    import jax.numpy as jnp

    lo, hi = (0.1, 0.9) if brightness is None else \
        (0.2 * brightness, 1.8 * brightness)
    fy = jnp.fft.fftfreq(h)[:, None]
    fx = jnp.fft.rfftfreq(w)[None, :]

    @jax.jit
    def scene_spectrum(key):
        base = jax.random.uniform(key, (h // 16 + 1, w // 16 + 1))
        img = jnp.repeat(jnp.repeat(base, 16, 0), 16, 1)[:h, :w]
        blur = jnp.exp(-2.0 * (jnp.pi * 4.0) ** 2 * (fy * fy + fx * fx))
        img = jnp.fft.irfft2(jnp.fft.rfft2(img) * blur, s=(h, w))
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        return jnp.fft.rfft2(lo + (hi - lo) * img)

    @jax.jit
    def frame(spec, shift, key):
        phase = jnp.exp(-2j * jnp.pi * (fy * shift[0] + fx * shift[1]))
        img = jnp.fft.irfft2(spec * phase, s=(h, w))
        noise = jnp.sqrt(jnp.maximum(alpha * img + beta, 0.0)) * \
            jax.random.normal(key, (h, w))
        return jnp.clip(img + noise, 0.0, 1.0).astype(jnp.float32)

    with jax.default_device(device):
        k_scene, k_shift, k_noise = jax.random.split(
            jax.random.PRNGKey(seed), 3)
        spec = scene_spectrum(k_scene)
        shifts = jax.random.uniform(k_shift, (n_frames, 2),
                                    minval=-max_shift, maxval=max_shift)
        shifts = shifts.at[0].set(0.0)
        keys = jax.random.split(k_noise, n_frames)
        out = np.empty((n_frames, h, w), np.float32)
        for n in range(n_frames):
            out[n] = np.asarray(frame(spec, shifts[n], keys[n]))
    return out


def _interior(img, border=16):
    return img[border:-border, border:-border]


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not available")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(device):
    """Phase 1: what JAX reports, and the card's name and power limit."""
    import jax
    fields = {"platform": device.platform, "kind": device.device_kind,
              "count": len(jax.devices())}
    log("device", **fields)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        fields["nvidia_smi"] = smi.stdout.strip().splitlines()
    elif device.platform == "gpu":
        raise RuntimeError("nvidia-smi not found on a GPU machine")
    else:
        fields["nvidia_smi"] = ["not available"]
    for line in fields["nvidia_smi"]:
        print(line, flush=True)
    return fields


def main_config(scale=2):
    """The default config with bench.py's noise model, before SNR resolution."""
    from hmsr_tpu.configs import default_config
    c = default_config()
    c.scale = scale
    c.verbose = 0
    c.noise_model.alpha = ALPHA
    c.noise_model.beta = BETA
    return c


def phase_main_path(device, burst):
    """Phase 2: ``process_arrays`` twice on the burst; returns findings."""
    import jax
    from hmsr_tpu.models.process import process_arrays

    out = {"burst_shape": list(burst.shape)}
    with jax.default_device(device):
        for name in ("cold", "second"):
            with CompileCounter() as cc:
                t0 = time.perf_counter()
                img, debug = process_arrays(burst[0], burst[1:], main_config(),
                                            cfa=CFA)
                secs = time.perf_counter() - t0
            out[f"{name}_s"] = round(secs, 3)
            out[f"{name}_compiles"] = cc.fields()
    inner = _interior(img)
    out.update(
        out_shape=list(img.shape),
        interior_finite_fraction=float(np.isfinite(inner).mean()),
        checksum=float(np.nansum(img[::31, ::37], dtype=np.float64)),
        peak_bytes_in_use=_peak_bytes(device))
    log("main", **out)
    if out["interior_finite_fraction"] != 1.0:
        raise AssertionError(f"non-finite interior: {out}")
    expect = (2 * burst.shape[1], 2 * burst.shape[2], 3)
    if tuple(img.shape) != expect:
        raise AssertionError(f"output shape {img.shape} != {expect}")
    return out


def burst_config(burst, std_curve, name="bright"):
    """bench.py's config for ``burst``: tile size from the reference frame's
    SNR (as ``process()`` resolves it), then variant ``name``'s changes."""
    from hmsr_tpu.configs import sanitize_config, update_snr_config
    c = main_config()
    c.accumulated_robustness_denoiser.enabled = False
    mean_b = float(burst[0].mean())
    update_snr_config(c, mean_b / std_curve[int(round(1000 * mean_b))])
    if name == "x1":
        c.scale = 1
        c.robustness.enabled = False
        c.robustness.save_mask = False
    elif name == "x3":
        c.scale = 3
        c.accumulated_robustness_denoiser.enabled = True
    elif name == "grey":
        c.mode = "grey"
    sanitize_config(c, burst[0].shape)
    return c


def phase_variants(device, size=FULL_SIZE, n_frames=N_FRAMES,
                   names=VARIANTS, seed=0, bright_burst=None):
    """Phase 3: compile and run each variant program once."""
    import jax
    import jax.numpy as jnp
    from hmsr_tpu.models.pipeline import make_pipeline
    from hmsr_tpu.noise import run_fast_MC

    brightness = {"dark": 0.07, "dark64": 0.02}
    results = {}
    with jax.default_device(device):
        std_curve, diff_curve = (np.asarray(a) for a in run_fast_MC(ALPHA, BETA))
        std_d = jnp.asarray(std_curve, jnp.float32)
        diff_d = jnp.asarray(diff_curve, jnp.float32)
        for name in names:
            if name in brightness:
                burst = make_burst(device, *size, n_frames, seed=seed,
                                   brightness=brightness[name])
            else:
                burst = bright_burst if bright_burst is not None else \
                    make_burst(device, *size, n_frames, seed=seed)
            c = burst_config(burst, std_curve, name)
            fn = jax.jit(make_pipeline(c, CFA, WB, jit=False))
            ref_d, comps_d = jnp.asarray(burst[0]), jnp.asarray(burst[1:])
            t0 = time.perf_counter()
            compiled = fn.lower(ref_d, comps_d, std_d, diff_d).compile()
            t_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
            img, _ = compiled(ref_d, comps_d, std_d, diff_d)
            img = jax.block_until_ready(img)
            t_run = time.perf_counter() - t0
            host = np.asarray(img)
            r = {"Ts": int(c.block_matching.tuning.tile_size),
                 "scale": c.scale, "mode": c.mode,
                 "out_shape": list(host.shape),
                 "compile_s": round(t_compile, 3), "run_s": round(t_run, 3),
                 "interior_finite_fraction":
                     float(np.isfinite(_interior(host)).mean())}
            log(f"variant {name}", **r)
            if r["interior_finite_fraction"] != 1.0:
                raise AssertionError(f"variant {name}: non-finite interior")
            results[name] = r
            del compiled, img, host, ref_d, comps_d
    return results


def parity_config(size, ts):
    """The e2e parity tiers' two-level schedule (the default program)."""
    from hmsr_tpu.configs import sanitize_config, update_snr_config
    c = main_config()
    c.debug = True
    c.block_matching.tuning.factors = [1, 2]
    c.block_matching.tuning.tile_size_factors = [1, 1]
    c.block_matching.tuning.search_radii = [1, 4]
    c.block_matching.tuning.metrics = ["L1", "L2"]
    update_snr_config(c, 20)
    c.block_matching.tuning.tile_size = ts
    c.block_matching.tuning.tile_sizes = [ts, ts]
    c.accumulated_robustness_denoiser.enabled = False
    sanitize_config(c, (size, size))
    return c


def phase_parity(device, cpu_device, tiers=PARITY_TIERS, n_frames=4):
    """Phase 4: the same program on ``device`` and ``cpu_device``."""
    import jax
    from hmsr_tpu.io.synthetic import make_synthetic_burst
    from hmsr_tpu.models.pipeline import make_pipeline

    std, diff = analytic_curves()
    results = {}
    for name, size, ts in tiers:
        ref, comps, _, _ = make_synthetic_burst(size, size, n_frames=n_frames,
                                                alpha=ALPHA, beta=BETA,
                                                seed=11)
        outs = []
        for dev in (device, cpu_device):
            c = parity_config(size, ts)
            args = [jax.device_put(a, dev) for a in (ref, comps, std, diff)]
            with jax.default_device(dev):
                img, debug = make_pipeline(c, CFA, WB)(*args)
            outs.append((np.nan_to_num(np.asarray(img)),
                         np.asarray(debug["flow"])))
        (img_a, flow_a), (img_b, flow_b) = outs
        d_img = np.abs(img_a - img_b)[8:-8, 8:-8]
        r = {"size": size, "Ts": ts,
             "flow_max": float(np.abs(flow_a - flow_b).max()),
             "img_mean": float(d_img.mean()), "img_max": float(d_img.max())}
        r["pass"] = all(r[k] < v for k, v in PARITY_GATES.items())
        log(f"parity {name}", **r)
        results[name] = r
    failed = [k for k, v in results.items() if not v["pass"]]
    if failed:
        raise AssertionError(f"parity gates {PARITY_GATES} failed: {failed}")
    return results


def _check(name, results, ok, **fields):
    fields["pass"] = bool(ok)
    log(f"fast {name}", **fields)
    results[name] = fields


def phase_fast_paths(device, burst, n_slab_frames=3, merge_band_rows=1000):
    """Phase 5: each XLA fast path against the plain reference, at the
    burst's size, on ``device`` (f32 everywhere; no matmul on these paths
    except the finishing chain, which asks for HIGHEST)."""
    import jax
    import jax.numpy as jnp
    from hmsr_tpu.finishing.device import make_postprocess_device
    from hmsr_tpu.finishing.raw2rgb import postprocess
    from hmsr_tpu.models.alignment import align, init_alignment
    from hmsr_tpu.models.ica import refine_ica, refine_ica_tiled
    from hmsr_tpu.models.kernels import estimate_kernels
    from hmsr_tpu.models.merge import merge
    from hmsr_tpu.models.merge_slab import merge_burst_slab
    from hmsr_tpu.models.merge_tiled import merge_ref_tiled, merge_tiled
    from hmsr_tpu.models.robustness import (compute_guide_image,
                                            compute_robustness,
                                            init_robustness,
                                            upscale_warp_stats,
                                            upscale_warp_stats_tiled)
    from hmsr_tpu.noise import run_fast_MC
    from hmsr_tpu.ops.accumfix import (REFILL_BORDER, STARVED_DEN,
                                       normalize_accum)
    from hmsr_tpu.ops.grey import compute_grey_image
    from hmsr_tpu.ops.stencils import local_stats_3x3

    results = {}
    H, W = burst.shape[1:]
    with jax.default_device(device):
        std_curve, diff_curve = (jnp.asarray(a, jnp.float32)
                                 for a in run_fast_MC(ALPHA, BETA))
        c = burst_config(burst, np.asarray(std_curve))
        Ts = int(c.block_matching.tuning.tile_size)
        n_iter = int(c.ica.tuning.n_iter)
        ref = jnp.asarray(burst[0])
        comps = jnp.asarray(burst[1:1 + n_slab_frames])

        @jax.jit
        def analyze(ref, comps):
            state = init_alignment(compute_grey_image(ref, "FFT"), c)
            stats = init_robustness(ref, CFA, WB, (std_curve, diff_curve), c)

            def one(frame):
                grey = compute_grey_image(frame, "FFT")
                flow = align(state, grey, c)
                r = compute_robustness(frame, stats, flow, CFA, WB, c)
                return flow, r, estimate_kernels(frame, c), grey
            flows, rmaps, covs, greys = jax.lax.map(one, comps)
            return state, flows, rmaps, covs, greys, estimate_kernels(ref, c)

        state, flows, rmaps, covs, greys, ref_covs = analyze(ref, comps)
        frame, flow, r, cov = comps[0], flows[0], rmaps[0], covs[0]
        log("fast setup", Ts=Ts, frame_shape=[H, W],
            slab_frames=int(comps.shape[0]), precision="float32")

        # ICA: tiled windows vs the gather formulation, finest level
        ica_args = (state.pyramid[-1], state.ica[-1], greys[0], flow, Ts,
                    n_iter)
        a = np.asarray(jax.jit(refine_ica, static_argnums=(4, 5))(*ica_args))
        b = np.asarray(jax.jit(refine_ica_tiled, static_argnums=(4, 5))(
            *ica_args))
        d = float(np.abs(a - b).max())
        _check("ica", results, d <= 1e-5, tiles=list(a.shape[:2]),
               max_abs=d, tol="atol 1e-5")

        # robustness warp: tiled vs gather Dodgson upscale-warp
        guide = compute_guide_image(frame, CFA, WB)
        means, _ = jax.jit(local_stats_3x3)(guide)
        want, wvalid = jax.jit(upscale_warp_stats, static_argnums=(1, 2))(
            means, 2, Ts, flow)
        got, gvalid = jax.jit(upscale_warp_stats_tiled,
                              static_argnums=(1, 2, 4))(means, 2, Ts, flow,
                                                        (H, W))
        m = np.asarray(wvalid)
        same_mask = bool((np.asarray(gvalid) == m).all())
        d = float(np.abs(np.asarray(got)[:, m] - np.asarray(want)[:, m]).max())
        _check("warp", results, same_mask and d <= 1e-5, max_abs=d,
               valid_masks_equal=same_mask, tol="atol 1e-5 on valid")

        # merge: tiled vs gather (the gather in HR row bands). The gather
        # reference places each sample at f32 absolute LR coordinates (ulp
        # up to 2.4e-4 at 4000 px) and takes its 3x3 centre as int() of
        # that; the tiled path derives the centre exactly from tile-local
        # integers. Where the exact sample position lies within f32
        # rounding of a pixel boundary the two centres differ by one and a
        # whole tap row moves. Gate: every element within the test
        # tolerance except at such positions (within 1e-3 px, float64),
        # and those at most 1e-3 of all elements.
        n_ch, out_h, out_w = 3, 2 * H, 2 * W
        zeros = jnp.zeros((n_ch, out_h, out_w), jnp.float32)
        s_ = float(c.scale)
        flow_np = np.asarray(flow, np.float64)

        def near_boundary(yy, xx):
            ly, lx = (yy + 0.5) / s_, (xx + 0.5) / s_
            ty = np.clip((ly // Ts).astype(int), 0, flow_np.shape[0] - 1)
            tx = np.clip((lx // Ts).astype(int), 0, flow_np.shape[1] - 1)
            my, mx = ly + flow_np[ty, tx, 1], lx + flow_np[ty, tx, 0]
            return np.minimum(np.abs(my - np.round(my)),
                              np.abs(mx - np.round(mx))) <= 1e-3

        for kernel in ("steerable", "iso"):
            ck = c.copy()
            ck.merging.kernel = kernel
            tn, td = jax.jit(lambda *a: merge_tiled(*a, CFA, ck))(
                frame, flow, cov, r, zeros, zeros)
            tn, td = np.asarray(tn), np.asarray(td)
            band_fn = jax.jit(lambda f, fl, cv, rr, nb, db, off: merge(
                f, fl, cv, rr, nb, db, CFA, ck, row_offset=off))
            bad = unexplained = 0
            worst = worst_explained = 0.0
            for start in range(0, out_h, merge_band_rows):
                rows = min(merge_band_rows, out_h - start)
                zb = jnp.zeros((n_ch, rows, out_w), jnp.float32)
                gn, gd = band_fn(frame, flow, cov, r, zb, zb,
                                 jnp.int32(start))
                for got_, want_ in ((tn[:, start:start + rows],
                                     np.asarray(gn)),
                                    (td[:, start:start + rows],
                                     np.asarray(gd))):
                    err = np.abs(got_ - want_)
                    out = err > 2e-4 + 1e-4 * np.abs(want_)
                    bad += int(out.sum())
                    _, yy, xx = np.nonzero(out)
                    nb = near_boundary(yy + start, xx)
                    unexplained += int((~nb).sum())
                    errs = err[out]
                    if errs.size:
                        worst_explained = max(worst_explained,
                                              float(errs[nb].max(initial=0)))
                    within = np.where(out, 0.0, err)
                    worst = max(worst, float(within.max()))
            share = bad / (2.0 * tn.size)
            _check(f"merge {kernel}", results,
                   unexplained == 0 and share <= 1e-3,
                   max_abs_inside_tol=worst, n_outside_tol=bad,
                   share_outside_tol=share,
                   n_outside_not_at_boundary=unexplained,
                   max_abs_at_boundary=worst_explained,
                   band_rows=merge_band_rows,
                   tol="atol 2e-4 rtol 1e-4 except within 1e-3 px of a "
                       "pixel boundary (<= 1e-3 of elements)")

        # burst-fused slab merge vs the scan of merge_tiled + merge_ref_tiled
        slab = np.asarray(jax.jit(lambda *a: merge_burst_slab(*a, CFA, c))(
            comps, flows, covs, rmaps, ref, ref_covs))

        @jax.jit
        def scan_merge(comps, flows, covs, rmaps, ref, ref_covs):
            def step(carry, xs):
                return merge_tiled(*xs, *carry, CFA, c), None
            (num, den), _ = jax.lax.scan(step, (zeros, zeros),
                                         (comps, flows, covs, rmaps))
            num, den = merge_ref_tiled(ref, ref_covs, num, den, CFA, c)
            return normalize_accum(num, den, refill_border=REFILL_BORDER), den
        want, den = scan_merge(comps, flows, covs, rmaps, ref, ref_covs)
        want = np.asarray(want)
        fed = np.asarray(den) > STARVED_DEN
        err = np.abs(slab - want)
        fed_bad = int((err[fed] > 5e-4 + 5e-4 * np.abs(want[fed])).sum())
        # starved pixels are refilled from slab-local context (README
        # "Parity notes"): convex mixes of neighbours, so in sample range
        starved = slab[~fed]
        in_range = bool(((starved >= -1e-3) & (starved <= 1 + 1e-3)).all())
        _check("slab", results,
               np.isfinite(slab).all() and fed_bad == 0 and in_range,
               wellfed_max_abs=float(err[fed].max()), n_outside_tol=fed_bad,
               starved_pixels=int((~fed).sum()),
               starved_max_abs=float(err[~fed].max()) if (~fed).any() else 0.0,
               starved_in_range=in_range,
               tol="well-fed atol 5e-4 rtol 5e-4; starved in [0, 1] +- 1e-3")

        # finishing: device chain (HIGHEST) vs the host scipy chain, on the
        # slab merge's image (the finishing input the served path sees)
        rgb = np.ascontiguousarray(np.transpose(slab, (1, 2, 0)))
        sharp = dict(c.postprocessing.sharpening)
        for gamma in (False, True):
            fin = jax.jit(make_postprocess_device(
                do_color_correction=False, do_tonemapping=False,
                do_gamma=gamma, sharpening_config=sharp))
            got = np.asarray(fin(jnp.asarray(rgb)))
            want = postprocess(rgb, do_color_correction=False,
                               do_tonemapping=False, do_gamma=gamma,
                               sharpening_config=sharp)
            d = float(np.abs(got - want).max())
            _check(f"finishing gamma={gamma}", results, d <= 1e-4,
                   shape=list(got.shape), max_abs=d, within_1em5=d <= 1e-5,
                   tol="atol 1e-4 (expected <= 1e-5 at HIGHEST)")
    failed = [k for k, v in results.items() if not v["pass"]]
    if failed:
        raise AssertionError(f"fast-path checks failed: {failed}")
    return results


def phase_sharded(devices, burst, meshes=((4, 1), (2, 2))):
    """Phase 6: the sharded pipeline over ``meshes`` vs the one-card scan."""
    import jax
    import jax.numpy as jnp
    from hmsr_tpu.models.pipeline import make_pipeline
    from hmsr_tpu.noise import run_fast_MC
    from hmsr_tpu.parallel import make_mesh, make_sharded_pipeline, pad_frames

    dev0 = devices[0]
    with jax.default_device(dev0):
        std_curve, diff_curve = (jnp.asarray(a, jnp.float32)
                                 for a in run_fast_MC(ALPHA, BETA))
    c = burst_config(burst, np.asarray(std_curve))
    # the sharded path normalizes the assembled accumulators like scan does
    c.tpu.pipeline = "scan"

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args)[0])
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args)[0])
        return out, cold, time.perf_counter() - t0

    results = {}
    args = [jax.device_put(a, dev0) for a in (burst[0], burst[1:])]
    with jax.default_device(dev0):
        want, cold, warm = timed(make_pipeline(c, CFA, WB), *args,
                                 std_curve, diff_curve)
    want = np.nan_to_num(np.asarray(want))
    results["single"] = {"cold_s": round(cold, 3), "burst_s": round(warm, 3)}
    log("sharded single-card scan", **results["single"])
    for nf, ns in meshes:
        mesh = make_mesh(nf, ns, devices)
        pipe = make_sharded_pipeline(c, CFA, WB, mesh)
        frames, weights = pad_frames(burst[1:], nf)
        got, cold, warm = timed(pipe, jnp.asarray(burst[0]),
                                jnp.asarray(frames), jnp.asarray(weights),
                                std_curve, diff_curve)
        got = np.nan_to_num(np.asarray(got))
        err = np.abs(got - want)
        n_bad = int((err > 5e-4 + 1e-3 * np.abs(want)).sum())
        r = {"out_shape": list(got.shape), "cold_s": round(cold, 3),
             "burst_s": round(warm, 3), "max_abs": float(err.max()),
             "n_outside_tol": n_bad, "tol": "atol 5e-4 rtol 1e-3",
             "pass": n_bad == 0}
        log(f"sharded mesh={nf}x{ns}", **r)
        results[f"{nf}x{ns}"] = r
    failed = [k for k, v in results.items() if not v.get("pass", True)]
    if failed:
        raise AssertionError(f"sharded parity failed: {failed}")
    return results


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1 runs only the sharded phase, on N GPUs")
    ap.add_argument("--json-out", default=None,
                    help="also write every finding to this JSON file")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX's default platform is {devices[0].platform!r}",
              file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"--devices {args.devices} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 1

    from hmsr_tpu.utils.compile_cache import enable_compile_cache
    log("compile_cache", dir=enable_compile_cache())

    dev = devices[0]
    findings = {"device": phase_device(dev)}
    t0 = time.perf_counter()
    burst = make_burst(dev, *FULL_SIZE, N_FRAMES)
    log("burst", shape=list(burst.shape), seconds=round(
        time.perf_counter() - t0, 3), mean=float(burst.mean()))
    if args.devices > 1:
        findings["sharded"] = phase_sharded(devices[:args.devices], burst)
    else:
        findings["main"] = phase_main_path(dev, burst)
        findings["variants"] = phase_variants(dev, bright_burst=burst)
        findings["parity"] = phase_parity(dev, jax.devices("cpu")[0])
        findings["fast_paths"] = phase_fast_paths(dev, burst)
    if args.json_out:
        import os
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(findings, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
