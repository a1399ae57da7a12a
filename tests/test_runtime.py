"""Process set-up shared by the entry points: the compile-cache helper,
and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from telr_jax.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and sets
    nothing in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.init_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.init_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repository, the smoke test exits non-zero with a message
    and prints no result line."""
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    proc = _smoke(cwd)
    assert proc.returncode != 0
    assert "FAILED" in proc.stderr
    assert '"ok"' not in proc.stdout
