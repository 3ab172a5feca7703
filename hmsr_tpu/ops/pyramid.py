"""Gaussian pyramid construction.

Parity notes vs the reference (utils_image.py:360-391, alignment.py:74-82):
- kernel: the scipy ``_gaussian_kernel1d(sigma=0.5*factor, radius=int(2*factor
  + 0.5))`` taps, reimplemented locally (order 0, normalized);
- *valid* separable convolution (no padding) followed by ``x[::factor]``
  subsampling cropped to ``floor(filtered/factor)`` samples — level shapes are
  NOT ``ceil(H/factor)``; they shrink by the kernel support first;
- ``factor == 1`` bypasses filtering entirely;
- pyramid list is returned coarse -> fine like the reference's reversed list.

The filter runs as per-tap strided slices + weighted sums (one fused
elementwise expression; only the kept samples are ever computed).
"""

import numpy as np
import jax.lax as lax
import jax.numpy as jnp


def gaussian_kernel1d(sigma, radius):
    """Normalized order-0 Gaussian taps on [-radius, radius]."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    phi /= phi.sum()
    return phi.astype(np.float32)


def downsample(img, factor, impl="slices"):
    """Gaussian blur (sigma = 0.5 * factor) + decimation by ``factor``.

    Valid correlation followed by ``[::factor]`` subsampling.

    ``impl="slices"`` (default) evaluates per-tap strided slices.
    ``impl="matmul"`` builds the strided-correlation operator per axis as a
    banded tap matrix and runs both passes as matmuls at HIGHEST precision
    (~1e-7 relative vs the slice form — a different summation order of the
    same taps).
    """
    if factor == 1:
        return img
    radius = int(4 * factor * 0.5 + 0.5)
    taps = gaussian_kernel1d(sigma=factor * 0.5, radius=radius)
    k = len(taps)

    h, w = img.shape
    fh, fw = h - 2 * radius, w - 2 * radius
    h2, w2 = fh // factor, fw // factor
    if h2 <= 0 or w2 <= 0:
        # level smaller than the filter support -> empty level (the
        # reference's filter-then-slice degenerates the same way)
        return jnp.zeros((max(h2, 0), max(w2, 0)), img.dtype)

    if impl == "matmul":
        import jax
        import jax.numpy as _jnp

        def band(n_out, n_in, transpose):
            # B[i, i*factor + t] = taps[t] — built from iotas on device
            # (a host constant this size would bloat the compile payload)
            sh = (n_out, n_in) if not transpose else (n_in, n_out)
            ii = lax.broadcasted_iota(jnp.int32, sh, 1 if transpose else 0)
            jj = lax.broadcasted_iota(jnp.int32, sh, 0 if transpose else 1)
            acc = _jnp.zeros(sh, _jnp.float32)
            for t in range(k):
                acc = acc + _jnp.float32(taps[t]) * \
                    (jj == ii * factor + t).astype(_jnp.float32)
            return acc

        hi = jax.lax.Precision.HIGHEST
        rows = band(h2, h, False)                    # (h2, h)
        cols = band(w2, w, True)                     # (w, w2)
        out = _jnp.dot(rows, img.astype(_jnp.float32), precision=hi)
        return _jnp.dot(out, cols, precision=hi).astype(img.dtype)

    out = None
    for t in range(k):
        v = lax.slice(img, (t, 0), (t + (h2 - 1) * factor + 1, w), (factor, 1))
        out = taps[t] * v if out is None else out + taps[t] * v
    out2 = None
    for t in range(k):
        v = lax.slice(out, (0, t), (h2, t + (w2 - 1) * factor + 1), (1, factor))
        out2 = taps[t] * v if out2 is None else out2 + taps[t] * v
    return out2


def build_gaussian_pyramid(image, factors):
    """Build the (coarse-first) Gaussian pyramid for the given factor chain."""
    pyramid = [downsample(image, factors[0])]
    for factor in factors[1:]:
        pyramid.append(downsample(pyramid[-1], factor))
    return pyramid[::-1]
