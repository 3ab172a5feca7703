"""Steerable merge-kernel covariance estimation (Alg. 5).

Rebuild of reference kernels.py: GAT variance stabilization, decimation to
grey, half-pixel gradients, per-pixel 2x2 structure tensor over the 2x2
up-left gradient window, closed-form eigendecomposition, anisotropy/detail
shaping (``linear`` or ``hard_threshold`` law), and the covariance
``Omega = k1^2 e1 e1^T + k2^2 e2 e2^T``.

The whole stage is one fused elementwise program per grey pixel — the
reference's ``cuda_estimate_kernel`` (kernels.py:138-191) becomes a handful
of elementwise ops.

Parity note: for an exactly zero structure tensor the reference's anisotropy
``A = 1 + sqrt((l1-l2)/(l1+l2))`` is NaN (0/0). With the default ``linear``
law that NaN propagates into the covariances and (through the merge weights)
into the output; the ``hard_threshold`` law falls back to isotropic
(kernels.py:229-237). Real raws never produce an exactly-zero tensor, but we
make the zero-tensor case well-defined by forcing A = 1 (isotropic) — same
result as the hard-threshold fallback, no NaNs.
"""

import jax.numpy as jnp

from ..ops.gat import gat
from ..ops.gradients import halfpixel_gradients
from ..ops.grey import decimate_to_grey
from ..ops.linalg2x2 import eigen_2x2
from ..utils.types import DEFAULT_FLOAT


def _compute_k(l1, l2, k_detail, k_denoise, d_th, d_tr, k_stretch, k_shrink,
               selection_law):
    tr = l1 + l2
    safe_tr = jnp.where(tr > 0, tr, 1.0)
    A = jnp.where(tr > 0, 1.0 + jnp.sqrt(jnp.maximum(l1 - l2, 0.0) / safe_tr), 1.0)
    D = jnp.clip(1.0 - jnp.sqrt(jnp.maximum(l1, 0.0)) / d_tr + d_th, 0.0, 1.0)

    if selection_law == "hard_threshold":
        k1 = jnp.where(A > 1.95, 1.0 / k_shrink, 1.0)
        k2 = jnp.where(A > 1.95, k_stretch, 1.0)
    elif selection_law == "linear":
        k1 = 1.0 + A / 2.0 * (1.0 / k_shrink - 1.0)
        k2 = 1.0 + A / 2.0 * (k_stretch - 1.0)
    else:
        raise ValueError(f"Unknown selection law: {selection_law}")

    kk1 = k_detail * ((1.0 - D) * k1 + D * k_denoise)
    kk2 = k_detail * ((1.0 - D) * k2 + D * k_denoise)
    return kk1, kk2


def estimate_kernels(img, config):
    """Covariance matrices Omega, sampled at every grey-grid pixel.

    Returns the symmetric components stacked channel-first, shape
    (3, gh, gw) = (xx, xy, yy), where the grey grid is the half-res
    Bayer-quad grid in bayer mode and the raw grid in grey mode.
    (Channel-first component layout: every component is a dense 2-D plane,
    no tiny trailing (2, 2) dims.)
    """
    bayer = config.mode == "bayer"
    mt = config.merging.tuning

    vst = gat(img, config.noise_model.alpha, config.noise_model.beta)
    grey = decimate_to_grey(vst) if bayer else vst

    grads = halfpixel_gradients(grey)          # (gh-1, gw-1, 2)
    gh, gw = grey.shape

    # Structure tensor per grey pixel: sum of outer products over the 2x2
    # gradient window at (y-1+i, x-1+j), i,j in {0,1}; out-of-range gradient
    # samples contribute zero (reference kernels.py:159-173).
    gxx = grads[..., 0] * grads[..., 0]
    gxy = grads[..., 0] * grads[..., 1]
    gyy = grads[..., 1] * grads[..., 1]

    def window_sum(a):
        p = jnp.pad(a, ((1, 1), (1, 1)))       # (gh+1, gw+1)
        return p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]   # (gh, gw)

    st00 = window_sum(gxx)
    st01 = window_sum(gxy)
    st11 = window_sum(gyy)

    (l1, l2), (e10, e11), (e20, e21) = eigen_2x2(st00, st01, st01, st11)

    k1, k2 = _compute_k(l1, l2, mt.k_detail, mt.k_denoise, mt.D_th, mt.D_tr,
                        mt.k_stretch, mt.k_shrink, config.merging.selection_law)

    k1_sq = k1 * k1
    k2_sq = k2 * k2
    c00 = k1_sq * e10 * e10 + k2_sq * e20 * e20
    c01 = k1_sq * e10 * e11 + k2_sq * e20 * e21
    c11 = k1_sq * e11 * e11 + k2_sq * e21 * e21

    return jnp.stack([c00, c01, c11]).astype(DEFAULT_FLOAT)
