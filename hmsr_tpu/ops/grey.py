"""Raw (CFA) -> grey conversions.

Two methods, mirroring the reference (Alg. 3 and the decimation kernel,
reference utils_image.py:58-115,346-357):

- ``fft_lowpass_grey``: zero the outer quarter of the centered 2-D spectrum
  and take the real part of the inverse transform. Implemented as a single
  complex FFT + multiplicative mask + inverse FFT (one runtime, no
  Torch<->Numba handoff).
- ``decimate_to_grey``: 2x2 Bayer-quad mean, a reshape-reduce (no kernel
  needed; XLA fuses it).

``fft_lowpass_grey`` (``jnp.fft``) is the default. The same low-pass is also
available as circulant matmuls (``impl="matmul"``) and as a two-stage
Cooley-Tukey matmul FFT (``impl="ct"``); both are explicit options, tested
equal to the FFT path.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.types import DEFAULT_FLOAT

#: named scope of the exact bf16x3-split selection matmuls: they are exact at
#: any matmul precision, so the precision audit (tests/test_precision.py)
#: allows them below HIGHEST.
EXACT_BF16X3_SCOPE = "exact_bf16x3"


def _lowpass_mask(h, w):
    """Binary keep-mask replicating the reference's slice-zeroing exactly.

    The reference zeroes ``[: h//4]`` and ``[-h//4 :]`` — note that
    ``-h//4`` is ``(-h)//4`` (floor), making the band asymmetric for
    non-multiple-of-4 sizes; we reproduce those exact slices.
    """
    my = np.ones((h, 1), dtype=np.float32)
    mx = np.ones((1, w), dtype=np.float32)
    my[: h // 4] = 0.0
    my[-h // 4:] = 0.0
    mx[:, : w // 4] = 0.0
    mx[:, -w // 4:] = 0.0
    return my * mx


def fft_lowpass_grey(img):
    """Low-pass grey image via spectral masking (Alg. 3).

    Evaluated with a real-to-complex rfft2 (half the FFT work of the
    reference's complex path): for a real input, taking the real part of
    ``ifft2(M * fft2(x))`` equals ``irfft2(Msym * rfft2(x))`` with the
    Hermitian-symmetrized mask ``Msym = (M(k) + M(-k)) / 2`` — M is 0/1 and
    only asymmetric on the band edge rows/cols for non-multiple-of-4 sizes,
    where Msym takes the value 1/2.
    """
    h, w = img.shape
    mask = _lowpass_mask(h, w)
    # unshifted, Hermitian-symmetrized mask, cropped to the rfft half-plane
    m_u = np.fft.ifftshift(mask)
    m_sym = 0.5 * (m_u + m_u[np.ix_((-np.arange(h)) % h, (-np.arange(w)) % w)])
    m_half = jnp.asarray(m_sym[:, : w // 2 + 1].astype(np.float32))
    spec = jnp.fft.rfft2(img.astype(DEFAULT_FLOAT))
    out = jnp.fft.irfft2(spec * m_half, s=(h, w))
    return out.astype(DEFAULT_FLOAT)


_CIRC_CACHE = {}


def _circulant_kernel(keep_mask_1d):
    """f32 circulant kernel ``k = Re(ifft(mask))`` of the 1-D low-pass.

    The spectral low-pass is a circular convolution with this kernel;
    ``C[i, j] = k[(i - j) mod n]``. Built in float64 on the host, rounded
    to f32 once per size. Only the (n,) kernel is kept host-side — the
    (n, n) circulant is expanded ON DEVICE (:func:`_circulant_device`), so
    the two 12MP circulants never become program literals (they would
    serialize to hundreds of MB of StableHLO).
    """
    k = np.fft.ifft(keep_mask_1d.astype(np.float64))
    return np.real(k).astype(np.float32)


def _circulant_device(k_host):
    """(n,) host kernel -> (n, n) ``C[i, j] = k[(i - j) mod n]`` on device.

    Gather-free Toeplitz expansion: tile the 2n-element diagonal table ``v[m] = k[(-m) mod n]`` (m < n) / ``k[2n - m]`` (m > n)
    n times; dropping the last n elements and reshaping to (n, 2n-1) shifts
    each row one step right, so element (i, j) = v[(j - i) mod 2n] and the
    first n columns are exactly C (|j - i| <= n-1 never hits the unused
    v[n]). Pure data movement, about 3 linear passes over device memory once
    per burst call (loop-invariant, hoisted out of the frames scan).
    """
    n = int(k_host.shape[0])
    v = np.zeros(2 * n, dtype=k_host.dtype)
    v[0] = k_host[0]
    if n > 1:
        v[1:n] = k_host[n - 1:0:-1]
        v[n + 1:] = k_host[n - 1:0:-1]
    t = jnp.tile(jnp.asarray(v), n)[: n * (2 * n - 1)]
    return t.reshape(n, 2 * n - 1)[:, :n]


def _imag_lowrank(n, keep_mask_1d):
    """Exact low-rank factors (U, V) of the imaginary circulant part.

    The reference's band slices are one frequency short of symmetric, so the
    mask's odd component ``m_o(k) = (m(k) - m(-k)) / 2`` is nonzero at only
    ~one frequency pair per axis; the imaginary circulant
    ``B[i,j] = sum_k (2 m_o(k)/n) sin(2 pi k (i-j)/n)`` is therefore rank
    ``2 |K+|`` (rank 2 for these masks — verified: singular values 1/2).
    Returns ``U (n, 2r), V (n, 2r)`` float64 with ``B = U @ V.T`` exactly.
    """
    m = keep_mask_1d.astype(np.float64)
    m_o = 0.5 * (m - m[(-np.arange(n)) % n])
    ks = [k for k in range(1, (n + 1) // 2) if m_o[k] != 0.0]
    cols_u, cols_v = [], []
    t = 2 * np.pi * np.arange(n) / n
    for k in ks:
        w = 2.0 * m_o[k] / n
        c, s = np.cos(k * t), np.sin(k * t)
        cols_u += [w * s, -w * c]
        cols_v += [c, s]
    if not cols_u:         # fully symmetric mask: B == 0
        return np.zeros((n, 0)), np.zeros((n, 0))
    return np.stack(cols_u, 1), np.stack(cols_v, 1)


def _circ_entries(h, w):
    """Host-side cache entry (k_h, k_w, u_h, v_h, u_w, v_w) for size (h, w)."""
    key = (h, w)
    if key not in _CIRC_CACHE:
        my = np.ones(h, dtype=np.float64)
        my[: h // 4] = 0.0
        my[-h // 4:] = 0.0
        mx = np.ones(w, dtype=np.float64)
        mx[: w // 4] = 0.0
        mx[-w // 4:] = 0.0
        kh = _circulant_kernel(np.fft.ifftshift(my))
        kw = _circulant_kernel(np.fft.ifftshift(mx))
        # The imaginary circulants are exactly rank-2 (one asymmetric
        # frequency per axis), so the B_h @ X @ B_w^T term collapses to a
        # (2, h) / (w, 2) sandwich — a rounding-level-exact rewrite that
        # halves the matmul FLOPs vs materializing B as (h, h) / (w, w).
        uh, vh = _imag_lowrank(h, np.fft.ifftshift(my))
        uw, vw = _imag_lowrank(w, np.fft.ifftshift(mx))
        # Cache HOST NumPy arrays only. Caching jnp arrays here leaked
        # trace-local tracers into later jit traces of the same size
        # (UnexpectedTracerError on every second trace); NumPy constants
        # are embedded per-trace by JAX and are always safe.
        _CIRC_CACHE[key] = (kh, kw,
                           uh.astype(np.float32), vh.astype(np.float32),
                           uw.astype(np.float32), vw.astype(np.float32))
    return _CIRC_CACHE[key]


_CIRC_DEV_CACHE = {}


def grey_matmul_consts(shape):
    """Eager (outside-jit) device circulants for :func:`fft_lowpass_grey_matmul`.

    Pass the result across your jit boundary as an ARGUMENT and down into
    ``compute_grey_image(..., consts=...)``. The in-trace fallback re-expands
    the Toeplitz structure on device every pipeline call, while closing over
    the expanded matrices embeds them as program literals. Bit-identical to
    both.
    """
    h, w = int(shape[0]), int(shape[1])
    try:
        from jax._src.core import trace_state_clean
        clean = trace_state_clean()
    except Exception:
        clean = True
    if not clean:
        raise RuntimeError(
            "grey_matmul_consts must be called OUTSIDE jit (eagerly): inside "
            "a trace its arrays become embedded module literals, the "
            "payload this function exists to avoid")
    key = (h, w)
    if key not in _CIRC_DEV_CACHE:
        k_h, k_w = _circ_entries(h, w)[:2]
        _CIRC_DEV_CACHE[key] = (_circulant_device(k_h),
                                _circulant_device(k_w))
    return _CIRC_DEV_CACHE[key]


def _ct_eligible(shape):
    """True when both axes have a usable Cooley-Tukey factor pair."""
    return (_ct_split(int(shape[0])) is not None
            and _ct_split(int(shape[1])) is not None)


def grey_consts_for(config, shape):
    """``grey_matmul_consts(shape)`` iff ``config`` resolves to the CIRCULANT
    MATMUL grey path (bayer mode, FFT method, ``matmul`` impl — or ``ct`` at
    a CT-ineligible size), else None. The Cooley-Tukey transform's factor
    constants are (n1+n2)-sized per-trace literals and need no argument
    threading. Shared by every jit-boundary owner (make_pipeline, the
    sharded pipeline)."""
    grey_impl = str(config.get("tpu", {}).get("grey_impl", "auto"))
    wants = (str(config.get("mode", "bayer")) == "bayer"
             and str(config.get("grey_method", "FFT")) == "FFT"
             and (grey_impl == "matmul"
                  or (grey_impl == "ct" and not _ct_eligible(shape))))
    try:
        from jax._src.core import trace_state_clean
        if not trace_state_clean():
            # caller jitted AROUND the consts computation (e.g. double-jit
            # of make_pipeline's wrapper): degrade to the in-trace expansion
            # fallback rather than embed literals or hard-fail
            return None
    except ImportError:
        pass
    return grey_matmul_consts(shape) if wants else None


def fft_lowpass_grey_matmul(img, consts=None):
    """:func:`fft_lowpass_grey` evaluated as matmuls.

    The keep-mask is separable (``my * mx``), so the transform is a
    separable circular convolution; taking the real part for a real input
    gives ``A_h @ img @ A_w^T - B_h @ img @ B_w^T`` with (A, B) the
    real/imaginary circulant parts per axis (the reference's band slices
    are one frequency row short of symmetric, so B is not exactly zero —
    reference utils_image.py:91-94). Mathematically identical to the FFT
    path; HIGHEST precision keeps the result within ~1e-5 of it.

    ``consts``: optional ``(a_h, a_w)`` from :func:`grey_matmul_consts`,
    threaded through the caller's jit boundary as arguments; None falls
    back to expanding the circulants in-trace (bit-identical).
    """
    h, w = img.shape
    k_h, k_w, u_h, v_h, u_w, v_w = _circ_entries(h, w)
    if consts is None:
        a_h = _circulant_device(k_h)
        a_w = _circulant_device(k_w)
    else:
        a_h, a_w = consts
        assert a_h.shape == (h, h) and a_w.shape == (w, w), \
            (a_h.shape, a_w.shape, (h, w))

    def dd(a, b, dims):
        return jax.lax.dot_general(a, b, dims,
                                   precision=jax.lax.Precision.HIGHEST)

    x = img.astype(DEFAULT_FLOAT)
    left = (((1,), (0,)), ((), ()))
    right = (((1,), (1,)), ((), ()))
    out = dd(dd(a_h, x, left), a_w, right)
    if u_h.size:
        # B_h X B_w^T = U_h (V_h^T X V_w) U_w^T with a (2, 2) middle
        mid = dd(dd(v_h.T, x, left), v_w, left)       # (2, 2)
        out = out - dd(dd(u_h, mid, left), u_w, right)
    return out.astype(DEFAULT_FLOAT)


_CT_CACHE = {}


def _ct_split(n):
    """Cooley-Tukey factor pair (n1, n2): n1 * n2 == n, both >= 8, with n1
    maximal <= sqrt(n) (minimizing the MAC count n*(n1+n2)). None when no
    such pair exists (prime/awkward n) — callers fall back to the direct
    circulant matmul."""
    import math
    for n1 in range(math.isqrt(n), 7, -1):
        if n % n1 == 0:
            return n1, n // n1
    return None


def _ct_entries(n):
    """Host constants for the 1-D masked spectral low-pass evaluated as a
    two-stage (Cooley-Tukey) matmul FFT.

    The direct circulant form ``C @ x`` costs n^2 MACs per output column;
    splitting n = n1 * n2 (j = n2 j1 + j2, k = k1 + n1 k2) factors the DFT
    into an (n1, n1) stage, an elementwise twiddle, and an (n2, n2) stage —
    ``X[k1 + n1 k2] = sum_j2 w_n2^(j2 k2) * (w_n^(j2 k1) *
    sum_j1 x[n2 j1 + j2] w_n1^(j1 k1))`` — i.e. ~n (n1 + n2) MACs. The 0/1
    keep-mask zeroes half the frequencies; at 12MP sizes the kept band
    aligns to whole k2 blocks, so the second stage only materializes the
    kept columns (``F2K``/``G2`` are (n2, nk) slices) and the inverse
    contracts straight from them. Masking in the (k1, k2) plane (``msel``,
    folded only when some block is partial) reproduces the reference's
    asymmetric band edge EXACTLY — no separate rank-2 imaginary correction
    is needed, the complex transform carries it. All factors are tiny
    ((n1+n2)-sized) host constants: unlike the (n, n) circulants there is
    no literal-payload concern (reference utils_image.py:58-115).
    """
    split = _ct_split(n)
    key = (n, split)
    if key in _CT_CACHE:
        return _CT_CACHE[key]
    if split is None:
        _CT_CACHE[key] = None
        return None
    n1, n2 = split
    m = np.ones(n, dtype=np.float64)
    m[: n // 4] = 0.0
    m[-n // 4:] = 0.0      # NB (-n)//4, the reference's asymmetric slice
    m = np.fft.ifftshift(m)
    mhat = m.reshape(n2, n1).T                       # [k1, k2] = m[k1+n1*k2]
    kept = np.nonzero(mhat.any(axis=0))[0]
    tau = -2j * np.pi
    f1 = np.exp(tau * np.outer(np.arange(n1), np.arange(n1)) / n1)
    tw = np.exp(tau * np.outer(np.arange(n1), np.arange(n2)) / n)
    f2k = np.exp(tau * np.outer(np.arange(n2), kept) / n2)
    g2 = np.exp(-tau * np.outer(kept, np.arange(n2)) / n2)
    g1 = np.exp(-tau * np.outer(np.arange(n1), np.arange(n1)) / n1) / n
    msel = mhat[:, kept]
    ent = dict(n=n, n1=n1, n2=n2, nk=int(kept.size),
               f1=f1.astype(np.complex64), tw=tw.astype(np.complex64),
               f2k=f2k.astype(np.complex64), g2=g2.astype(np.complex64),
               g1=g1.astype(np.complex64),
               msel=(None if np.all(msel == 1.0)
                     else msel.astype(np.float32)))
    _CT_CACHE[key] = ent      # host NumPy only (tracer-leak gotcha above)
    return ent


def _ct_ein(sub, a, b):
    return jnp.einsum(sub, a, b, precision=jax.lax.Precision.HIGHEST)


def _ct_fwd_rows(x, e, real_in):
    """Masked forward transform along axis 0: (n, B) -> (n1*nk, B) complex."""
    xr = x.reshape(e["n1"], e["n2"], -1)
    if real_in:
        a = jax.lax.complex(_ct_ein('kj,jmb->kmb', e["f1"].real, xr),
                            _ct_ein('kj,jmb->kmb', e["f1"].imag, xr))
    else:
        a = _ct_ein('kj,jmb->kmb', e["f1"], xr)
    a = a * e["tw"][:, :, None]
    c = _ct_ein('kmb,mq->kqb', a, e["f2k"])
    if e["msel"] is not None:
        c = c * e["msel"][:, :, None]
    return c.reshape(e["n1"] * e["nk"], x.shape[1])


def _ct_inv_rows(y, e, real_out):
    """Inverse from the kept axis-0 frequencies: (n1*nk, B) -> (n, B)."""
    c = _ct_ein('kqb,qm->kmb', y.reshape(e["n1"], e["nk"], -1), e["g2"])
    c = c * np.conj(e["tw"])[:, :, None]
    if real_out:
        out = (_ct_ein('jk,kmb->jmb', e["g1"].real, c.real)
               - _ct_ein('jk,kmb->jmb', e["g1"].imag, c.imag))
    else:
        out = _ct_ein('jk,kmb->jmb', e["g1"], c)
    return out.reshape(e["n"], y.shape[1])


def _ct_fwd_cols(x, e):
    """Masked forward transform along axis 1: (B, n) -> (B, n1*nk) complex."""
    a = _ct_ein('kj,bjm->bkm', e["f1"], x.reshape(-1, e["n1"], e["n2"]))
    a = a * e["tw"][None, :, :]
    c = _ct_ein('bkm,mq->bkq', a, e["f2k"])
    if e["msel"] is not None:
        c = c * e["msel"][None, :, :]
    return c.reshape(x.shape[0], e["n1"] * e["nk"])


def _ct_inv_cols(y, e):
    """Inverse from the kept axis-1 frequencies: (B, n1*nk) -> (B, n)."""
    c = _ct_ein('bkq,qm->bkm', y.reshape(-1, e["n1"], e["nk"]), e["g2"])
    c = c * np.conj(e["tw"])[None, :, :]
    out = _ct_ein('jk,bkm->bjm', e["g1"], c)
    return out.reshape(y.shape[0], e["n"])


def fft_lowpass_grey_ct(img, consts=None):
    """:func:`fft_lowpass_grey` as a two-stage Cooley-Tukey matmul FFT.

    Same linear operator as the FFT and circulant-matmul paths (float
    rounding only, ~1e-5 class like matmul-vs-FFT); ~9x fewer real MACs
    than the direct circulant form at 12MP (each axis costs n(n1+n2)
    instead of n^2, and both inner stages run only on the kept half of the
    spectrum). Falls back to the circulant matmul when an axis has no
    usable factor pair (prime sizes) — consts, if supplied, are only for
    that fallback.
    """
    h, w = img.shape
    eh, ew = _ct_entries(h), _ct_entries(w)
    if eh is None or ew is None:
        return fft_lowpass_grey_matmul(img, consts=consts)
    x = img.astype(DEFAULT_FLOAT)
    z = _ct_fwd_rows(x, eh, real_in=True)      # (hk, w)  complex
    z = _ct_fwd_cols(z, ew)                    # (hk, wk) complex
    z = _ct_inv_cols(z, ew)                    # (hk, w)  complex
    out = _ct_inv_rows(z, eh, real_out=True)   # (h, w)   real
    return out.astype(DEFAULT_FLOAT)


def _sel_dot_cols(x, w, w2, phase):
    """Exact ``x[:, phase::2]`` (w -> w2 columns) as a selection matmul.

    The (h, w) @ (w, w2) 0/1 selection is exact: the selection is 0/1
    (bf16-exact) and the data rides an exact bf16x3 split, so the product is
    exact at any matmul precision. The selection matrix is built from iotas
    on device (a big host constant would bloat the program's literals).
    """
    ii = jax.lax.broadcasted_iota(jnp.int32, (w, w2), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (w, w2), 1)
    sel = (ii == 2 * jj + phase).astype(jnp.float32)

    mask = jnp.int32(-65536)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    h_ = jax.lax.bitcast_convert_type(bits & mask, jnp.float32)
    r_ = x - h_
    rbits = jax.lax.bitcast_convert_type(r_, jnp.int32)
    m_ = jax.lax.bitcast_convert_type(rbits & mask, jnp.float32)
    l_ = r_ - m_
    d = lambda p: jnp.dot(p, sel, preferred_element_type=jnp.float32)
    with jax.named_scope(EXACT_BF16X3_SCOPE):
        return (d(h_) + d(m_)) + d(l_)


def decimate_to_grey(img, impl="reshape"):
    """2x2 mean over each Bayer quad -> (h/2, w/2) grey image.

    ``impl="reshape"`` (default) is a reshape-reduce. ``impl="matmul"`` runs
    the quad reduction as two 0.5-valued selection matmuls (column pairs
    then row pairs). Each matmul is exact (0.5 is bf16-exact, the data rides
    an exact bf16x3 split); the result differs from the reshape form by at
    most 1 ulp (the column means round before the row means — a different
    but equally valid summation order for the same 4-tap mean).
    """
    h, w = img.shape
    if impl == "matmul":
        h2, w2 = h // 2, w // 2
        x = img[:2 * h2, :2 * w2].astype(DEFAULT_FLOAT)
        ii = jax.lax.broadcasted_iota(jnp.int32, (2 * w2, w2), 0)
        jj = jax.lax.broadcasted_iota(jnp.int32, (2 * w2, w2), 1)
        sc = jnp.where(ii // 2 == jj, jnp.float32(0.5), 0.0)
        ri = jax.lax.broadcasted_iota(jnp.int32, (h2, 2 * h2), 0)
        rj = jax.lax.broadcasted_iota(jnp.int32, (h2, 2 * h2), 1)
        sr = jnp.where(rj // 2 == ri, jnp.float32(0.5), 0.0)

        mask = jnp.int32(-65536)
        bits = jax.lax.bitcast_convert_type(x, jnp.int32)
        hp = jax.lax.bitcast_convert_type(bits & mask, jnp.float32)
        r_ = x - hp
        rb = jax.lax.bitcast_convert_type(r_, jnp.int32)
        mp = jax.lax.bitcast_convert_type(rb & mask, jnp.float32)
        lp = r_ - mp
        d = lambda p: jnp.dot(p, sc, preferred_element_type=jnp.float32)
        with jax.named_scope(EXACT_BF16X3_SCOPE):
            y = (d(hp) + d(mp)) + d(lp)             # (h, w2) column means
        bits = jax.lax.bitcast_convert_type(y, jnp.int32)
        hp = jax.lax.bitcast_convert_type(bits & mask, jnp.float32)
        r_ = y - hp
        rb = jax.lax.bitcast_convert_type(r_, jnp.int32)
        mp = jax.lax.bitcast_convert_type(rb & mask, jnp.float32)
        lp = r_ - mp
        d2 = lambda p: jnp.dot(sr, p, preferred_element_type=jnp.float32)
        with jax.named_scope(EXACT_BF16X3_SCOPE):
            out = (d2(hp) + d2(mp)) + d2(lp)
        return out.astype(DEFAULT_FLOAT)
    quads = img[: (h // 2) * 2, : (w // 2) * 2].reshape(h // 2, 2, w // 2, 2)
    return jnp.mean(quads, axis=(1, 3)).astype(DEFAULT_FLOAT)


def compute_grey_image(img, method, impl="auto", consts=None):
    """Dispatch on the grey method name used by the config.

    ``impl``: "auto" / "fft" (``jnp.fft``), or the explicit matmul forms of
    the same operator, "matmul" (circulant) and "ct" (Cooley-Tukey).
    ``consts``: optional :func:`grey_matmul_consts` pair threaded through
    the caller's jit boundary (matmul path only).
    """
    if method == "FFT":
        if impl == "ct":
            return fft_lowpass_grey_ct(img, consts=consts)
        if impl == "matmul":
            return fft_lowpass_grey_matmul(img, consts=consts)
        return fft_lowpass_grey(img)
    if method == "decimating":
        return decimate_to_grey(img)
    raise NotImplementedError(f"Unknown grey method {method}")
