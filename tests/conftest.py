"""Test configuration: run on the CPU with an 8-device virtual mesh.

Tests need no accelerator; the multi-device sharding tests use the virtual
device mesh. The compile cache follows
:func:`hmsr_tpu.utils.compile_cache.enable_compile_cache`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from hmsr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


# ---------------------------------------------------------------------------
# slow-test selection: the default run skips the tests listed in
# slow_manifest.txt (measured >= 10 s each) to stay within a few minutes. Run everything with ``--runslow`` (or HMSR_SLOW=1) — CI
# convention documented in CLAUDE.md. The manifest is regenerated from
# ``pytest --durations=0`` output, not hand-curated.
# ---------------------------------------------------------------------------

_MANIFEST = os.path.join(os.path.dirname(__file__), "slow_manifest.txt")


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests listed in tests/slow_manifest.txt")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: measured >= 10 s; skipped unless --runslow")


def pytest_collection_modifyitems(config, items):
    import pytest
    if config.getoption("--runslow") or os.environ.get("HMSR_SLOW"):
        return
    try:
        with open(_MANIFEST) as f:
            slow_ids = {ln.strip() for ln in f if ln.strip()}
    except OSError:
        return
    skip = pytest.mark.skip(reason="slow (see tests/slow_manifest.txt); "
                                   "use --runslow")
    for item in items:
        if item.nodeid in slow_ids:
            item.add_marker(pytest.mark.slow)
            item.add_marker(skip)
