"""Device-side (jnp) finishing ISP — the default postprocess chain.

The host chain (``raw2rgb.postprocess``: reference raw2rgb.py:212-250) runs
scipy/NumPy at full SR resolution — at 48MP x 3 channels the three
``gaussian_filter`` calls of the unsharp mask alone cost seconds of host
time that never showed in the device-pipeline benchmark (VERDICT r03
weak #8). This module is a numerics-parity jnp port of every step except
the cv2-Mertens exposure fusion (which stays on the host; the reference
delegates to OpenCV there too, raw2rgb.py:153-170):

- color correction  : row-normalized CCM einsum (raw2rgb.py:115-130),
- unsharp mask      : separable Gaussian, scipy ``gaussian_filter``
                      parity (truncate=4.0 radius, nearest boundary),
- devignette        : inverse cos^4 model (raw2rgb.py:204-210),
- smoothstep tonemap: the no-cv2 fallback (3x^2 - 2x^3),
- gamma             : clip + x^(1/2.2).

Parity: tests/test_finishing_device.py pins each step to the host chain
(atol ~1e-5 float32). The convolutions and the colour einsum ask for HIGHEST
precision, so a GPU does not run them in TF32.
"""

import numpy as np

import jax
import jax.numpy as jnp

from .raw2rgb import get_color_matrix

_HIGHEST = jax.lax.Precision.HIGHEST


def _gauss_kernel(sigma):
    """scipy.ndimage.gaussian_filter kernel: radius int(4*sd + 0.5)."""
    lw = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-lw, lw + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32), lw


def gaussian_blur_nearest(img, sigma):
    """Per-channel separable Gaussian on (H, W, C); nearest boundary.

    Matches ``scipy.ndimage.gaussian_filter(x, sigma, mode="nearest")``.
    """
    k, lw = _gauss_kernel(sigma)
    kern = jnp.asarray(k)
    h, w, c = img.shape
    x = jnp.transpose(img, (2, 0, 1))[:, None]          # (C, 1, H, W)
    x = jnp.pad(x, ((0, 0), (0, 0), (lw, lw), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x, kern.reshape(1, 1, 2 * lw + 1, 1), (1, 1), "VALID",
        precision=_HIGHEST)
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (lw, lw)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x, kern.reshape(1, 1, 1, 2 * lw + 1), (1, 1), "VALID",
        precision=_HIGHEST)
    return jnp.transpose(x[:, 0], (1, 2, 0))


def make_postprocess_device(do_color_correction=True, do_tonemapping=True,
                            do_gamma=True, sharpening_config=None,
                            do_devignette=False, xyz2cam=None,
                            image_shape=None):
    """Build a jittable (H, W, 3) -> (H, W, 3) finishing function.

    ``do_tonemapping`` here applies the smoothstep fallback only — callers
    that want cv2-Mertens fusion (reference behavior when cv2 is present)
    must run that step on the host (models/process.py routes it).
    """
    if do_color_correction:
        cam2rgb = jnp.asarray(np.linalg.inv(get_color_matrix(xyz2cam)))
    sharpen = (sharpening_config is not None
               and sharpening_config.get("enabled", False))
    if sharpen:
        radius = sharpening_config.get("radius", 3)
        amount = sharpening_config.get("amount", 0.5)

    def fn(img):
        img = img.astype(jnp.float32)
        if do_color_correction:
            img = jnp.clip(jnp.einsum("ij,hwj->hwi", cam2rgb, img,
                                      precision=_HIGHEST), 0.0, 1.0)
        if sharpen:
            img = img + amount * (img - gaussian_blur_nearest(img, radius))
        if do_devignette:
            h, w, _ = img.shape
            vy = jnp.abs(jnp.linspace(-h / w * jnp.pi / 2,
                                      h / w * jnp.pi / 2, h))
            vx = jnp.abs(jnp.linspace(-jnp.pi / 2, jnp.pi / 2, w))
            vf = jnp.outer(vy, vx)
            img = (2.0 - jnp.cos(vf) ** 4)[:, :, None] * img
        if do_tonemapping:
            img = jnp.clip(img, 0.0, 1.0)
            img = 3.0 * img ** 2 - 2.0 * img ** 3
        img = jnp.clip(img, 0.0, 1.0)
        if do_gamma:
            img = img ** (1.0 / 2.2)
        return jnp.clip(img, 0.0, 1.0)

    return fn
