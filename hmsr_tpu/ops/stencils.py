"""Small fixed-window stencils as fused XLA expressions.

Replaces the reference's per-pixel CUDA window loops (local stats
robustness.py:268-294, local min robustness.py:669-687, box-filter conv2d
block_matching.py:47-62) with shifted-slice reductions that XLA fuses into a
handful of elementwise passes — no gather, no conv, static shapes.
"""

import jax.numpy as jnp


def _edge_pad(img, r, axes=(-2, -1)):
    pad = [(0, 0)] * img.ndim
    for ax in axes:
        pad[ax % img.ndim] = (r, r)
    return jnp.pad(img, pad, mode="edge")


def local_stats_3x3(img):
    """Clamped-boundary 3x3 local mean and variance along the last two dims.

    ``img``: (..., H, W). Returns ``(mean, var)`` with the same shape. The
    boundary replicates edge pixels, matching the reference's clamped index
    arithmetic (robustness.py:281-284).
    """
    h, w = img.shape[-2], img.shape[-1]

    def box3(x):
        # separable 3x3 box: 3+3 shifted-slice passes instead of 9
        p = _edge_pad(x, 1, axes=(-2,))
        r = p[..., 0:h, :] + p[..., 1:1 + h, :] + p[..., 2:2 + h, :]
        p = _edge_pad(r, 1, axes=(-1,))
        return p[..., :, 0:w] + p[..., :, 1:1 + w] + p[..., :, 2:2 + w]

    s = box3(img)
    s2 = box3(img * img)
    mean = s / 9.0
    var = s2 / 9.0 - mean * mean
    return mean, var


def local_min_5x5(img):
    """Clamped-boundary 5x5 local minimum (Alg. 9, robustness.py:669-687).

    Separable (min of mins): 5 + 5 shifted-slice passes instead of 25.
    """
    h, w = img.shape[-2], img.shape[-1]
    p = _edge_pad(img, 2, axes=(-2,))
    rows = None
    for i in range(5):
        v = p[..., i:i + h, :]
        rows = v if rows is None else jnp.minimum(rows, v)
    p = _edge_pad(rows, 2, axes=(-1,))
    out = None
    for j in range(5):
        v = p[..., :, j:j + w]
        out = v if out is None else jnp.minimum(out, v)
    return out


def box_sum_valid(img, k):
    """Valid k x k box-filter sum along the last two dims via integral images.

    Output spatial shape is ``(H - k + 1, W - k + 1)``. Used for the windowed
    L2 norms of the block-matching search areas (the reference uses a conv2d
    with an all-ones kernel, block_matching.py:60-62).
    """
    c = jnp.cumsum(jnp.cumsum(img, axis=-2), axis=-1)
    pad = [(0, 0)] * (img.ndim - 2) + [(1, 0), (1, 0)]
    c = jnp.pad(c, pad)
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = h - k + 1, w - k + 1
    a = c[..., k:k + oh, k:k + ow]
    b = c[..., k:k + oh, 0:ow]
    d = c[..., 0:oh, k:k + ow]
    e = c[..., 0:oh, 0:ow]
    return a - b - d + e
