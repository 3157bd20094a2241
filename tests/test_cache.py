"""Compile-cache location rule (utils/cache.py).

``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache directory and
nothing else is configured; otherwise the cache sits at a fixed path in the
checkout, ``build/jax_cache/<backend>-jax<version>`` (the path is part of
JAX's cache key, so it must not move between runs)."""

import os

import pytest

from slam_process_tpu.utils import cache


@pytest.fixture
def fresh(monkeypatch):
    """A not-yet-configured cache module whose config writes are recorded."""
    import jax

    calls = []
    monkeypatch.setattr(cache, "_DONE", None)
    monkeypatch.delenv("SLAM_PROCESS_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.setattr(cache, "_jax_config_dir", lambda: None)
    return calls


def test_env_var_is_the_only_cache_dir(fresh, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert cache.enable_persistent_cache() == str(tmp_path / "jc")
    assert fresh == []                      # nothing set in code
    assert not (tmp_path / "jc").exists()   # JAX owns the directory


def test_default_dir_is_fixed_in_checkout(fresh, monkeypatch, tmp_path):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "DEFAULT_BASE", tmp_path / "jax_cache")
    got = cache.enable_persistent_cache()
    want = tmp_path / "jax_cache" / f"cpu-jax{jax.__version__}"
    assert got == str(want) and want.is_dir()
    assert ("jax_compilation_cache_dir", str(want)) in fresh
    # Idempotent: a second call configures nothing new.
    n = len(fresh)
    assert cache.enable_persistent_cache() == str(want)
    assert len(fresh) == n


def test_default_base_is_inside_the_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_BASE == cache.Path(repo) / "build" / "jax_cache"


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_subdir_names_only_backend_and_jax_version(backend):
    import jax

    assert cache.default_cache_dir(backend) == (
        cache.DEFAULT_BASE / f"{backend}-jax{jax.__version__}")


def test_disable_switch(fresh, monkeypatch):
    monkeypatch.setenv("SLAM_PROCESS_TPU_NO_COMPILE_CACHE", "1")
    assert cache.enable_persistent_cache() is None
    assert fresh == []


def test_ensure_portable_cpu_isa_appends_and_respects(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    assert cache.ensure_portable_cpu_isa() is True
    assert "--xla_cpu_max_isa=AVX2" in os.environ["XLA_FLAGS"]
    # idempotent
    assert cache.ensure_portable_cpu_isa() is True
    assert os.environ["XLA_FLAGS"].count("xla_cpu_max_isa") == 1
    # an explicit different cap is respected, not overridden
    monkeypatch.setenv("XLA_FLAGS", "--xla_cpu_max_isa=SSE4_2")
    assert cache.ensure_portable_cpu_isa() is False
    assert os.environ["XLA_FLAGS"] == "--xla_cpu_max_isa=SSE4_2"


def test_conftest_lane_runs_capped():
    """The CPU test lane itself runs with the portable cap (conftest
    applies it before jax initializes)."""
    import jax

    if jax.default_backend() != "cpu":
        pytest.skip("cpu-lane check")
    assert "xla_cpu_max_isa=AVX2" in os.environ.get("XLA_FLAGS", "")
