"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU backend with 8 virtual devices (the multi-device
paths' dry-run environment); the platform is pinned here, before any test
touches jax (backends initialize lazily), unless ``JAX_PLATFORMS`` names
other platforms. Tests that need the GPU carry the ``gpu`` marker and skip
through the ``gpu_device`` fixture when no card is present; on a machine
with one, ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs
them.
"""

import os

import jax

from pbrt_tpu.utils import compile_cache

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
jax.config.update("jax_platforms",
                  os.environ.get("JAX_PLATFORMS") or "cpu")
# cache compiled programs across test runs (renders are compile-heavy)
compile_cache.enable()


# The XLA CPU client segfaults inside backend_compile_and_load after ~145
# compile-heavy tests in one process (reproduced r1+r2; machine has >100 GB
# free, so it is client state, not system OOM). Dropping the executable
# caches between modules keeps the client small; the on-disk persistent
# cache makes any recompiles cheap.
import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip (decided at run time, never at
    import, so every test worker collects the same tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU: the card-side checks run in chip_smoke.py")
    return devs[0]
