"""The persistent compilation cache is placed in one way for every entry
point: JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""

import os

import jax
import pytest

from xraytracer import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                              restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_unset_uses_checkout_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_cli_and_scripts_use_the_helper():
    """No entry point sets a cache directory of its own."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    callers = ["bench.py", "bench_fwdbwd.py", "bench_lights.py",
               "bench_mesh.py", "chip_smoke.py",
               os.path.join("xraytracer", "cli.py")]
    for rel in callers:
        src = open(os.path.join(root, rel)).read()
        assert "enable_compile_cache()" in src, rel
        assert "jax_compilation_cache_dir" not in src, rel
