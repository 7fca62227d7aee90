"""The shared compile-cache helper and the native packer's build key."""

import os

import jax

from hpgq.io import native
from hpgq.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_env_set_means_nothing_set_in_code(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".bench", "jax_cache")
    assert compile_cache.DEFAULT_DIR == want
    assert compile_cache.cache_dir() == want
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])


def test_packer_build_key_tracks_source_command_and_cpu(tmp_path):
    src = tmp_path / "packer.cpp"
    src.write_bytes(b"int x;\n")
    key = native.build_key(["g++", "-O3"], str(src), cpu="cpu-a")
    assert key == native.build_key(["g++", "-O3"], str(src), cpu="cpu-a")
    assert key != native.build_key(["g++", "-O2"], str(src), cpu="cpu-a")
    assert key != native.build_key(["g++", "-O3"], str(src), cpu="cpu-b")
    src.write_bytes(b"int y;\n")
    assert key != native.build_key(["g++", "-O3"], str(src), cpu="cpu-a")


def test_packer_builds_under_its_key():
    path = native.library_path()
    assert path == os.path.join(native.BUILD_ROOT, native.build_key(),
                                "_packer.so")
    if native.get_lib() is not None:  # hosts without g++ use numpy
        assert os.path.dirname(native.loaded_path).startswith(
            native.BUILD_ROOT)
        assert os.path.exists(native.loaded_path)
