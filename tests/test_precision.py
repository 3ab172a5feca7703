"""Precision audit: no matmul or convolution below HIGHEST on the default
path, so a GPU cannot run it in TF32.

Walks the jaxpr (sub-jaxprs included) and lists every ``dot_general`` and
``conv_general_dilated`` whose precision is not HIGHEST. The only allowed
exceptions are the exact bf16x3-split selection matmuls, traced under
``grey.EXACT_BF16X3_SCOPE``: their operands are exact in bf16, so they are
exact at any matmul precision.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hmsr_tpu.configs import default_config, sanitize_config, update_snr_config
from hmsr_tpu.finishing.device import make_postprocess_device
from hmsr_tpu.models.pipeline import make_pipeline
from hmsr_tpu.ops.grey import EXACT_BF16X3_SCOPE

AUDITED = ("dot_general", "conv_general_dilated")
HIGHEST = jax.lax.Precision.HIGHEST


def _is_highest(precision):
    if isinstance(precision, (tuple, list)):
        return len(precision) > 0 and all(p == HIGHEST for p in precision)
    return precision == HIGHEST


def _subjaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def audit(jaxpr, allowed=False, found=None):
    """Returns (n_audited, offenders) for ``jaxpr`` and its sub-jaxprs."""
    found = found if found is not None else {"n": 0, "bad": []}
    for eqn in jaxpr.eqns:
        here = allowed or EXACT_BF16X3_SCOPE in str(eqn.source_info.name_stack)
        if eqn.primitive.name in AUDITED:
            found["n"] += 1
            precision = eqn.params.get("precision")
            if not here and not _is_highest(precision):
                found["bad"].append((eqn.primitive.name, precision))
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                audit(sub, here, found)
    return found["n"], found["bad"]


def _pipeline_jaxpr(scale, **tpu):
    c = default_config()
    c.scale = scale
    c.block_matching.tuning.factors = [1, 2]
    c.block_matching.tuning.tile_size_factors = [1, 1]
    c.block_matching.tuning.search_radii = [1, 4]
    c.block_matching.tuning.metrics = ["L1", "L2"]
    update_snr_config(c, 25)
    c.noise_model.alpha, c.noise_model.beta = 1.8e-4, 3.0e-6
    c.tpu.update(tpu)
    sanitize_config(c, (64, 64))
    fn = make_pipeline(c, np.array([[0, 1], [1, 2]]), [1.0] * 3, jit=False)
    args = (jnp.zeros((64, 64)), jnp.zeros((2, 64, 64)), jnp.zeros(1001),
            jnp.zeros(1001))
    return jax.make_jaxpr(fn)(*args).jaxpr


@pytest.mark.parametrize("scale", [2, 1.5])
def test_default_pipeline_has_no_low_precision_matmul(scale):
    n, bad = audit(_pipeline_jaxpr(scale))
    assert bad == [], bad


@pytest.mark.parametrize("cc", [False, True])
def test_device_finishing_is_highest(cc):
    fn = make_postprocess_device(
        do_color_correction=cc, do_tonemapping=False, do_gamma=True,
        sharpening_config={"enabled": True, "amount": 1.5, "radius": 3})
    n, bad = audit(jax.make_jaxpr(fn)(jnp.zeros((32, 32, 3))).jaxpr)
    assert n == (3 if cc else 2)        # two blur passes (+ the colour einsum)
    assert bad == [], bad


@pytest.mark.parametrize("grey_impl", ["matmul", "ct"])
def test_explicit_grey_matmul_paths_are_highest(grey_impl):
    n, bad = audit(_pipeline_jaxpr(2, grey_impl=grey_impl))
    assert n > 0
    assert bad == [], bad


def test_explicit_selection_matmuls_allowlisted():
    from hmsr_tpu.models.robustness import compute_guide_image
    from hmsr_tpu.ops.grey import decimate_to_grey
    from hmsr_tpu.ops.lut import lut_lookup
    from hmsr_tpu.ops.pyramid import downsample
    x = jnp.zeros((32, 48))
    fns = [
        lambda: compute_guide_image(x, np.array([[0, 1], [1, 2]]),
                                    [1.0] * 3, impl="matmul"),
        lambda: decimate_to_grey(x, impl="matmul"),
        lambda: downsample(x, 2, impl="matmul"),
        lambda: lut_lookup(jnp.zeros(1001), x, impl="onehot"),
    ]
    for fn in fns:
        n, bad = audit(jax.make_jaxpr(fn)().jaxpr)
        assert n > 0 and bad == [], bad


def test_audit_flags_default_precision():
    a = jnp.ones((4, 4))
    n, bad = audit(jax.make_jaxpr(lambda: jnp.dot(a, a))().jaxpr)
    assert n == 1 and len(bad) == 1

    def scoped():
        with jax.named_scope(EXACT_BF16X3_SCOPE):
            return jnp.dot(a, a)
    n, bad = audit(jax.make_jaxpr(scoped)().jaxpr)
    assert n == 1 and bad == []
