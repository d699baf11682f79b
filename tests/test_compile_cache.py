"""Where JAX's persistent compilation cache goes."""

import jax

from genome_downsampler_tpu.utils.compile_cache import (
    CHECKOUT_CACHE,
    enable_compile_cache,
)


def test_env_dir_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_checkout_dir_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(CHECKOUT_CACHE)
        assert jax.config.jax_compilation_cache_dir == str(CHECKOUT_CACHE)
        assert CHECKOUT_CACHE.parent.joinpath("chip_smoke.py").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
