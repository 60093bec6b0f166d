"""Test harness.

The suite runs where ``JAX_PLATFORMS`` says, the CPU by default. On the CPU
it gets 8 virtual devices, so every sharding / collective test runs without
a multi-GPU host (SURVEY.md §4 — the JAX answer to multi-host testing), and
Pallas kernels run in interpret mode where a test asks for it.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU. On the card:
``JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu``.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, the
    same collection on every xdist worker)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found "
                    f"{jax.devices()[0].platform}")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop XLA executables between test modules.

    The full suite (~150 XLA-CPU compilations) deterministically segfaulted
    inside ``backend_compile_and_load`` at the same late test on this
    machine while every subset passed — an accumulated-compiler-state
    failure. Clearing JAX's compiled-program caches at module boundaries
    bounds that state; the cost is re-tracing shared helpers (a few seconds
    per module), the benefit is a suite that can certify green in ONE
    invocation."""
    yield
    jax.clear_caches()
