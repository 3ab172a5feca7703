"""Small-table lookups.

The noise-model curves are 1001-entry LUTs indexed at ``round(1000 * x)``
(reference robustness.py:504-533). The default ``impl="gather"`` indexes the
table directly. ``impl="onehot"`` evaluates the same lookup without a gather,
as a two-level one-hot contraction:

    idx = 32*hi + lo
    P[n, h] = sum_l onehot_lo[n, l] * T2[h, l]     (one (N,32)@(32,32) matmul)
    out[n]  = sum_h onehot_hi[n, h] * P[n, h]      (select-reduce)

The one-hot rows are exact in bf16 (0/1), and the matmul accumulates the
single selected f32 entry — results are bit-exact vs the gather.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.types import DEFAULT_FLOAT

_SPLIT = 32  # 1024 = 32 * 32


def lut_lookup(tables, x, scale=1000.0, chunk_elems=None, impl="gather"):
    """Exact ``[t[clip(round(scale*x), 0, len(t)-1)] for t in tables]``.

    ``tables``: list of 1-D float arrays, all the same length (<= 1024).
    ``x``: float array of any shape. Returns a list of arrays shaped like x.
    ``chunk_elems``: optional bound on elements processed per step (bounds
    the (N, 32) one-hot temporaries of ``impl="onehot"``).
    """
    single = not isinstance(tables, (list, tuple))
    if single:
        tables = [tables]
    n_entries = int(tables[0].shape[0])
    if impl == "gather":
        idx = jnp.clip(jnp.round(scale * x), 0, n_entries - 1).astype(jnp.int32)
        outs = [t.astype(DEFAULT_FLOAT)[idx] for t in tables]
        return outs[0] if single else outs
    assert impl == "onehot", impl
    assert n_entries <= _SPLIT * _SPLIT, n_entries

    t2s = [
        jnp.pad(t.astype(DEFAULT_FLOAT), (0, _SPLIT * _SPLIT - n_entries)
                ).reshape(_SPLIT, _SPLIT)
        for t in tables
    ]

    shape = x.shape
    xf = x.reshape(-1)
    n = xf.shape[0]

    def eval_chunk(xc):
        idx = jnp.clip(jnp.round(scale * xc), 0, n_entries - 1).astype(jnp.int32)
        hi = idx // _SPLIT
        lo = idx - hi * _SPLIT
        iota = jnp.arange(_SPLIT, dtype=jnp.int32)
        b_lo = (lo[:, None] == iota).astype(DEFAULT_FLOAT)
        a_hi = hi[:, None] == iota
        outs = []
        for t2 in t2s:
            # HIGHEST precision -> bf16x3 passes; the one-hot rows are exact
            # in bf16 and select a single f32 entry, so the result is
            # bit-exact vs the gather.
            p = jax.lax.dot_general(
                b_lo, t2.T, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            outs.append(jnp.sum(jnp.where(a_hi, p, 0.0), axis=-1))
        return outs

    if chunk_elems is None or n <= chunk_elems:
        outs = eval_chunk(xf)
    else:
        c = int(chunk_elems)
        n_chunks = -(-n // c)
        xp = jnp.pad(xf, (0, n_chunks * c - n)).reshape(n_chunks, c)
        stacked = jax.lax.map(lambda xc: eval_chunk(xc), xp)
        outs = [s.reshape(-1)[:n] for s in stacked]

    outs = [o.reshape(shape).astype(DEFAULT_FLOAT) for o in outs]
    return outs[0] if single else outs
