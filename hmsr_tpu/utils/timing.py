"""Hierarchical, verbose-gated stage timing.

JAX analogue of the reference's ``timer``/``getTime`` print tracing
(reference utils.py:26-30,128-146): ``cuda.synchronize()`` becomes
``jax.block_until_ready`` on the stage outputs, and the same verbose-level
semantics are preserved (verbose>=2 times stages, >=3 times sub-steps).
"""

import time

import jax


def _block(out):
    """Block until all jax arrays in a pytree are ready (device sync)."""
    try:
        jax.block_until_ready(out)
    except Exception:
        pass
    return out


def getTime(current_time, label, print_time=True, space_size=50):
    """Print the elapsed time since ``current_time``; return a new timestamp."""
    if print_time:
        print(label, " " * (space_size - len(label)), ": ",
              round((time.perf_counter() - current_time) * 1000, 2), "milliseconds")
    return time.perf_counter()


def timer(func, enabled, start_s=None, end_s=None, space_size=50):
    """Wrap ``func`` with device-synchronized wall-clock printing.

    Mirrors the reference decorator semantics (utils.py:128-146): when
    ``enabled`` is falsy the function is returned untouched (zero overhead).
    """
    if not enabled:
        return func

    def wrapper(*args, **kwargs):
        _block(args)
        t1 = time.perf_counter()
        if start_s is not None:
            print(start_s)
        out = func(*args, **kwargs)
        _block(out)
        if end_s is not None:
            print(end_s, " " * (space_size - len(end_s)), ": ",
                  round((time.perf_counter() - t1) * 1000, 2), "milliseconds")
        return out

    return wrapper
