"""The CLI's persistent compilation cache location (utils/compile_cache.py)."""

from pathlib import Path

import jax
import pytest

from nextgenmap_tpu.utils.compile_cache import enable_compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert enable_compile_cache() == got          # no pid, time or tmp part
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_installed_package_sets_no_dir(monkeypatch, tmp_path, restore_cache_dir):
    """Outside a checkout (CACHE_DIR's parent has no pyproject.toml, as in
    site-packages) nothing is set."""
    from nextgenmap_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "CACHE_DIR", tmp_path / ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    (tmp_path / "pyproject.toml").write_text("")
    assert compile_cache.enable_compile_cache() == str(tmp_path / ".jax_cache")
