"""The persistent compilation cache helper: one fixed directory, or the one
``JAX_COMPILATION_CACHE_DIR`` names."""

import subprocess
import sys
from pathlib import Path

import jax

from lbfgs_ffnn.utils import compile_cache as cc

REPO = Path(__file__).resolve().parents[1]


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.compile_cache_dir() == str(REPO / ".jax_cache")
    assert cc.compile_cache_dir() == cc.compile_cache_dir()


def test_default_dir_is_git_ignored():
    ignored = subprocess.run(
        ["git", "-C", str(REPO), "check-ignore", "-q", ".jax_cache/x"],
        capture_output=True)
    if ignored.returncode == 128:  # not a git checkout (e.g. an archive)
        assert "/.jax_cache/" in (REPO / ".gitignore").read_text()
    else:
        assert ignored.returncode == 0


def test_env_var_is_honoured_and_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_dir_is_set_when_env_var_absent(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert cc.enable_compile_cache() == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]


def test_cache_lands_in_the_env_dir(tmp_path):
    """End to end in a fresh process: a compiled program is written to the
    directory the environment names."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "from lbfgs_ffnn.utils.compile_cache import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "print(float(jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(4)).sum()))\n"
    )
    env = {"JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": str(tmp_path),
           "PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert any("jit" in p.name for p in tmp_path.rglob("*")), "no cache entry written"
