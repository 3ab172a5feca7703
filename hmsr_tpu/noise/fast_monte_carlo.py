"""Fast Monte-Carlo noise-curve calibration, vectorized on-device.

Rebuild of reference fast_monte_carlo.py. The reference distributes a NumPy
MC over a ``multiprocessing.Pool`` of CPU cores (fast_monte_carlo.py:84-121);
here the same estimator is a single vmapped ``jax.random`` program:

For the affine noise model ``std^2 = alpha*I + beta`` and each brightness
level b (1001 levels on [0, 1]):
- sigma(b): mean over patches of the per-3x3-patch std of clipped noisy
  samples (two draws averaged);
- d(b): mean absolute difference of two independent clipped 3x3 patch means.

The clipping to [0, 1] makes the curve nonlinear near 0 and 1; like the
reference, MC runs only outside the analytic linearity bounds and the middle
is interpolated linearly in the squared domain (fast_monte_carlo.py:123-154).
Curves are cached per (alpha, beta).

Reference curve resolution preserved: 1001 float entries (BASELINE.md).
"""

import functools
import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

N_PATCHES = int(os.environ.get("HMSR_MC_PATCHES", int(1e5)))
N_BRIGHTNESS_LEVELS = 1000
TOL = 3


def get_non_linearity_bound(alpha, beta, tol=TOL):
    """Brightness range [xmin, xmax] where clipping is negligible (+-tol sigma)."""
    tol_sq = tol * tol
    xmin = tol_sq / 2 * (alpha + np.sqrt(tol_sq * alpha * alpha + 4 * beta))
    xmax = (2 + tol_sq * alpha
            - np.sqrt((2 + tol_sq * alpha) ** 2 - 4 * (1 + tol_sq * beta))) / 2
    return xmin, xmax


@functools.partial(jax.jit, static_argnames=("n_patches",))
def _mc_levels(key, b_array, alpha, beta, n_patches=N_PATCHES):
    """(sigmas, diffs) for each brightness in ``b_array`` (vectorized MC)."""

    def one_level(args):
        key, b = args
        k1, k2 = jax.random.split(key)
        base = jnp.full((n_patches, 3, 3), b, jnp.float32)
        std = jnp.sqrt(jnp.maximum(base * alpha + beta, 0.0))
        p1 = jnp.clip(base + std * jax.random.normal(k1, base.shape), 0.0, 1.0)
        p2 = jnp.clip(base + std * jax.random.normal(k2, base.shape), 0.0, 1.0)
        std_mean = 0.5 * jnp.mean(jnp.std(p1, axis=(1, 2)) + jnp.std(p2, axis=(1, 2)))
        diff_mean = jnp.mean(jnp.abs(jnp.mean(p1, axis=(1, 2))
                                     - jnp.mean(p2, axis=(1, 2))))
        return diff_mean, std_mean

    keys = jax.random.split(key, b_array.shape[0])
    diffs, sigmas = jax.lax.map(one_level, (keys, b_array))
    return sigmas, diffs


def _regular_mc(b_array, alpha, beta, seed=0):
    key = jax.random.PRNGKey(seed)
    sigmas, diffs = _mc_levels(key, jnp.asarray(b_array, jnp.float32),
                               float(alpha), float(beta))
    return np.asarray(sigmas, np.float64), np.asarray(diffs, np.float64)


def _interp_squared(b_array, lo, hi):
    """Linear interpolation in the squared domain between endpoint values."""
    t = (b_array - b_array[0]) / (b_array[-1] - b_array[0])
    return np.sqrt(t * (hi ** 2 - lo ** 2) + lo ** 2)[1:-1]


_CACHE = {}
_DISK_CACHE_DIR = os.environ.get(
    "HMSR_NOISE_CACHE", os.path.join(tempfile.gettempdir(), "hmsr_noise_cache"))


def _disk_cache_path(cache_key):
    tag = "_".join(f"{v:.12g}" if isinstance(v, float) else str(v)
                   for v in cache_key)
    return os.path.join(_DISK_CACHE_DIR, f"curves_{tag}.npz")


def run_fast_MC(alpha, beta, seed=0):
    """(std_curve, diff_curve), each 1001 entries over brightness in [0, 1].

    Results are cached in memory and on disk per (alpha, beta, seed) — the
    reference regenerates curves each run (super_resolution.py:254); caching
    by noise-model parameters was already listed as the intended improvement
    (SURVEY.md section 5 checkpoint notes).
    """
    cache_key = (round(float(alpha), 12), round(float(beta), 12), seed, N_PATCHES)
    if cache_key in _CACHE:
        return _CACHE[cache_key]
    path = _disk_cache_path(cache_key)
    try:
        data = np.load(path)
        out = (data["std"], data["diff"])
        _CACHE[cache_key] = out
        return out
    except Exception:
        pass

    xmin, xmax = get_non_linearity_bound(alpha, beta, TOL)
    n = N_BRIGHTNESS_LEVELS
    imin = int(np.ceil(xmin * n)) + 1
    imax = int(np.floor(xmax * n)) - 1

    brightness = np.arange(n + 1) / n
    if imin > n or imin >= imax:
        sigmas, diffs = _regular_mc(brightness, alpha, beta, seed)
        _store(cache_key, sigmas, diffs)
        return sigmas, diffs

    sigmas = np.empty(n + 1)
    diffs = np.empty(n + 1)

    nl_brightness = np.concatenate((brightness[:imin + 1], brightness[imax:]))
    s_nl, d_nl = _regular_mc(nl_brightness, alpha, beta, seed)
    sigmas[:imin + 1], diffs[:imin + 1] = s_nl[:imin + 1], d_nl[:imin + 1]
    sigmas[imax:], diffs[imax:] = s_nl[imin + 1:], d_nl[imin + 1:]

    b_mid = brightness[imin - 1:imax + 2]
    sigmas[imin:imax + 1] = _interp_squared(b_mid, sigmas[imin], sigmas[imax])
    diffs[imin:imax + 1] = _interp_squared(b_mid, diffs[imin], diffs[imax])

    _store(cache_key, sigmas, diffs)
    return sigmas, diffs


def _store(cache_key, sigmas, diffs):
    _CACHE[cache_key] = (sigmas, diffs)
    try:
        os.makedirs(_DISK_CACHE_DIR, exist_ok=True)
        np.savez(_disk_cache_path(cache_key), std=sigmas, diff=diffs)
    except Exception:
        pass


def round_iso(iso):
    """Round a non-standard ISO to the nearest power-of-two standard ISO
    (100, 200, 400, ...) — reference utils.py:122-125."""
    import math
    n = round(math.log2(iso / 100))
    return int(100 * (2 ** n))


def load_noise_curves(iso, data_dir):
    """Load precomputed curves ``noise_model_{std,diff}_ISO_{iso}.npy``
    (the reference's commented-out loading path, super_resolution.py:243-251)."""
    iso = round_iso(iso)
    std = np.load(os.path.join(data_dir, f"noise_model_std_ISO_{iso}.npy"))
    diff = np.load(os.path.join(data_dir, f"noise_model_diff_ISO_{iso}.npy"))
    return std, diff


def fit_alpha_beta(std_curve):
    """Recover an affine noise model from a std curve: ``std^2 = a*b + beta``.

    Least squares over the mid-range brightness (clipping distorts the curve
    ends — see ``test_clipping_reduces_std_at_edges``). Used when curves are
    loaded from ISO-keyed files and no (alpha, beta) pair is otherwise known
    (the GAT in kernels.py:64 needs one).
    """
    n = len(std_curve)
    b = np.arange(n) / (n - 1)
    mid = slice(n // 10, (9 * n) // 10)
    # the curves store the MEAN 9-sample ddof=0 std, a biased estimator:
    # E[s] = sigma * sqrt(2/9) * Gamma(4.5) / Gamma(4)  (~0.9137 sigma)
    try:
        from scipy.special import gamma as _G
        c9 = np.sqrt(2.0 / 9.0) * _G(4.5) / _G(4.0)
    except ImportError:       # keep scipy optional (like every other use)
        c9 = 0.9138748917925524     # sqrt(2/9) * Gamma(4.5) / Gamma(4)
    sigma2 = (np.asarray(std_curve[mid]) / c9) ** 2
    A = np.stack([b[mid], np.ones_like(b[mid])], axis=-1)
    coef, *_ = np.linalg.lstsq(A, sigma2, rcond=None)
    alpha, beta = float(coef[0]), float(max(coef[1], 0.0))
    return alpha, beta


def monte_carlo_curves(alpha, beta, seed=0):
    """Brute-force MC over every brightness level (the reference's offline
    ``monte_carlo_simulation.py``), for generating noise_model_*.npy files."""
    brightness = np.arange(N_BRIGHTNESS_LEVELS + 1) / N_BRIGHTNESS_LEVELS
    return _regular_mc(brightness, alpha, beta, seed)
