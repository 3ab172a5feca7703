"""The one compile-cache policy: the environment wins, else <repo>/.jax_cache."""

import os
import subprocess
import sys
from pathlib import Path

import jax

from hmsr_tpu.utils import compile_cache as cc

REPO = Path(__file__).resolve().parents[1]


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    return calls


def test_env_set_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert cc.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_env_unset_uses_repo_dir(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    calls = _record_updates(monkeypatch)
    assert cc.enable_compile_cache() == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]


def _run_cached_jit(env):
    code = ("import jax; from hmsr_tpu.utils.compile_cache import "
            "enable_compile_cache; d = enable_compile_cache(); "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
            " jax.jit(lambda x: x * 3 + 1)(2.0).block_until_ready(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_cache_goes_to_env_dir(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **{cc.ENV_VAR: str(tmp_path)})
    used, configured = _run_cached_jit(env)
    assert used == configured == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_cache_defaults_to_repo_dir():
    env = {k: v for k, v in os.environ.items() if k != cc.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    used, configured = _run_cached_jit(env)
    assert used == configured == str(REPO / ".jax_cache")
