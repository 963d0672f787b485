"""The backend rules every device path shares: the capability helper
(utils.on_accelerator) and the persistent compile cache
(utils.enable_compile_cache)."""

import os

import jax
import pytest

from panvc3_tpu import utils


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them, so no test
    switches the process onto a cache directory."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_env_set_configures_nothing(
    config_updates, monkeypatch, tmp_path
):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    for backend in ("gpu", "cpu", None):
        assert utils.enable_compile_cache(backend) == str(tmp_path)
    assert config_updates == []


def test_compile_cache_unset_uses_the_checkout_on_gpu(config_updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = utils.enable_compile_cache("gpu")
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(utils.__file__)))
    assert d == os.path.join(checkout, ".jax_cache")
    assert ("jax_compilation_cache_dir", d) in config_updates


@pytest.mark.parametrize("backend", ["cpu", None])
def test_compile_cache_off_on_cpu(config_updates, monkeypatch, backend):
    """None reads the default backend, which is the CPU under the tests."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert utils.enable_compile_cache(backend) is None
    assert config_updates == []


@pytest.mark.parametrize(
    "backend,expected", [("cpu", False), ("gpu", True), (None, False)]
)
def test_on_accelerator(backend, expected):
    """None reads the default backend, which is the CPU under the tests."""
    assert utils.on_accelerator(backend) is expected
