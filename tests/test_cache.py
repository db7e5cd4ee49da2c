"""Persistent-compilation-cache wiring (utils/cache.py)."""

import os
import subprocess
import sys

import jax
import pytest

from lfbm5d_tpu.utils import cache
from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cache_dir(monkeypatch):
    monkeypatch.delenv("LFBM5D_NO_COMPILE_CACHE", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_sets_cache_dir(no_cache_dir, tmp_path, monkeypatch):
    """Unset: the cache goes to <checkout>/.jax_cache, whatever the cwd;
    a second call leaves the configured dir alone."""
    monkeypatch.chdir(tmp_path)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.DEFAULT_DIR == want
    assert enable_persistent_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
    assert not os.path.exists(tmp_path / ".jax_cache")
    assert enable_persistent_compilation_cache() == want


def test_env_dir_is_honoured(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX takes it and the code sets none."""
    want = str(tmp_path / "env_cache")
    code = (
        "import jax\n"
        "from lfbm5d_tpu.utils.cache import enable_persistent_compilation_cache\n"
        "print(enable_persistent_compilation_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=want,
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("LFBM5D_NO_COMPILE_CACHE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert out[-2:] == [want, want]


def test_opt_out_env(monkeypatch):
    monkeypatch.setenv("LFBM5D_NO_COMPILE_CACHE", "1")
    assert enable_persistent_compilation_cache() is None


def test_cache_round_trip(no_cache_dir):
    """A jitted program executes correctly with the disk cache enabled."""
    enable_persistent_compilation_cache()

    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 2.0 + 1.0)
    out = f(jnp.arange(8.0))
    assert float(out[3]) == 7.0
