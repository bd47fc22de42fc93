"""Platform choice, compile-cache placement, and chip_smoke.py's refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from rawalign_tpu import platform, runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,kernels", [("gpu", True), ("cpu", False)])
def test_use_kernels_by_platform(backend, kernels):
    assert platform.use_kernels(backend) is kernels


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_use_kernels_rejects_other_platforms(backend):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform.use_kernels(backend)


def test_use_kernels_defaults_to_jax_backend():
    assert platform.use_kernels() is False  # the tests run on the CPU


@pytest.fixture
def cache_config():
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_in_checkout_by_default(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache_config.update("jax_compilation_cache_dir", None)
    path = runtime.enable_compilation_cache()
    assert path == os.path.join(ROOT, "build", "jax_cache")
    assert cache_config.jax_compilation_cache_dir == path
    assert cache_config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_compile_cache_honours_env(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    cache_config.update("jax_compilation_cache_dir", None)
    path = runtime.enable_compilation_cache()
    assert path == str(tmp_path)
    # JAX reads the variable itself; the program sets no directory
    assert cache_config.jax_compilation_cache_dir is None


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs 1 GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
