"""Vectorized closed-form 2x2 linear algebra.

The reference implements these as per-thread CUDA device functions
(reference linalg.py:14-226). Here every routine is a batched, elementwise
closed form over arrays of matrix *components*, trivially fusable by XLA
into surrounding stencils.

Matrices are represented either as stacked components ``(a, b, c, d)`` for
``[[a, b], [c, d]]`` or as arrays with trailing ``(2, 2)`` dims; component form
is preferred on the hot path (no tiny trailing dims for the tiler to chew on).
"""

import jax.numpy as jnp

from ..utils.types import EPSILON_DIV


def solve_2x2(a00, a01, a10, a11, b0, b1):
    """Solve ``A @ x = b`` analytically (no determinant guard, like the
    reference solve_2x2, linalg.py:14-34)."""
    det = a00 * a11 - a01 * a10
    x0 = (a11 * b0 - a01 * b1) / det
    x1 = (a00 * b1 - a10 * b0) / det
    return x0, x1


def invert_2x2(m00, m01, m10, m11, eps=EPSILON_DIV):
    """Analytic 2x2 inverse; falls back to the identity when |det| <= eps
    (reference linalg.py:37-64)."""
    det = m00 * m11 - m01 * m10
    ok = jnp.abs(det) > eps
    det_i = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 1.0)
    i00 = jnp.where(ok, m11 * det_i, 1.0)
    i01 = jnp.where(ok, -m01 * det_i, 0.0)
    i10 = jnp.where(ok, -m10 * det_i, 0.0)
    i11 = jnp.where(ok, m00 * det_i, 1.0)
    return i00, i01, i10, i11


def quad_mat_prod(a00, a01, a10, a11, x1, x2):
    """Quadratic form ``x^T A x`` for ``x = [x1, x2]`` (reference linalg.py:66-84)."""
    return a00 * x1 * x1 + x1 * x2 * (a01 + a10) + a11 * x2 * x2


def _real_polyroots_2(b, c):
    """Real roots of ``X^2 + b X + c`` sorted by decreasing magnitude
    (reference linalg.py:86-122 with a=1; delta clamped at 0 against fp noise)."""
    delta = jnp.maximum(b * b - 4.0 * c, 0.0)
    sq = jnp.sqrt(delta)
    r1 = (-b + sq) / 2.0
    r2 = (-b - sq) / 2.0
    big_first = jnp.abs(r1) >= jnp.abs(r2)
    l0 = jnp.where(big_first, r1, r2)
    l1 = jnp.where(big_first, r2, r1)
    return l0, l1


def eigen_2x2(m00, m01, m10, m11):
    """Eigenvalues (|l1| >= |l2|) and unit eigenvectors of a symmetric 2x2.

    Vectorized transcription of the reference's branchy device code
    (linalg.py:125-185): the identity-multiple special case picks the
    canonical basis; otherwise ``e1 = [m00 + m01 - l2, m10 + m11 - l2]``
    ("averaging 2 for increased reliability") with axis-aligned special cases,
    and ``e2`` the sign-consistent orthogonal complement.
    """
    l1, l2 = _real_polyroots_2(-(m00 + m11), m00 * m11 - m01 * m10)

    v0 = m00 + m01 - l2
    v1 = m10 + m11 - l2

    norm = jnp.sqrt(v0 * v0 + v1 * v1)
    safe_norm = jnp.where(norm > 0, norm, 1.0)
    n0 = v0 / safe_norm
    n1 = v1 / safe_norm
    sign = jnp.sign(n0) + (n0 == 0)  # copysign(1, x): treat +0 as +1
    # general case
    e1_0, e1_1 = n0, n1
    e2_0, e2_1 = -n1 * sign, jnp.abs(n0)

    # axis-aligned special cases (order matters: v0 == 0 checked first)
    zero0 = v0 == 0
    zero1 = jnp.logical_and(~zero0, v1 == 0)
    e1_0 = jnp.where(zero0, 0.0, jnp.where(zero1, 1.0, e1_0))
    e1_1 = jnp.where(zero0, 1.0, jnp.where(zero1, 0.0, e1_1))
    e2_0 = jnp.where(zero0, 1.0, jnp.where(zero1, 0.0, e2_0))
    e2_1 = jnp.where(zero0, 0.0, jnp.where(zero1, 1.0, e2_1))

    # identity-multiple special case
    ident = jnp.logical_and(m01 == 0, m00 == m11)
    e1_0 = jnp.where(ident, 1.0, e1_0)
    e1_1 = jnp.where(ident, 0.0, e1_1)
    e2_0 = jnp.where(ident, 0.0, e2_0)
    e2_1 = jnp.where(ident, 1.0, e2_1)

    return (l1, l2), (e1_0, e1_1), (e2_0, e2_1)
