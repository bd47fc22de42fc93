"""Test configuration.

By default the tests run on a virtual 8-device CPU platform, so sharding
and multi-device tests run anywhere. ``python -m pytest tests -m gpu``
(on a machine with an NVIDIA GPU) leaves JAX on the GPU and runs the
tests that need the card; elsewhere those skip through the ``gpu``
fixture.
"""

import os

import pytest


def pytest_configure(config):
    if config.getoption("markexpr") == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run python -m pytest tests -m gpu on the card")
