"""Test harness config.

CPU lane (the default): an 8-device virtual CPU mesh + x64, forced
before any jax import, so every golden test also exercises the
shard_map DP path.

GPU lane (``KMERTOOLS_TEST_GPU=1``, on a machine with a card): the
default backend is left alone. Run it as
``KMERTOOLS_TEST_GPU=1 python -m pytest -m gpu tests/``; tests marked
``gpu`` take the ``gpu_device`` fixture, which skips them wherever JAX
finds no GPU (always, in the CPU lane).
"""

import os

GPU_LANE = os.environ.get("KMERTOOLS_TEST_GPU") == "1"

if not GPU_LANE:
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["KMERTOOLS_QUIET"] = "1"
# small device batches keep CPU-backend test runtime low
os.environ.setdefault("KMERTOOLS_TARGET_CODES", str(1 << 16))

import jax

if not GPU_LANE:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference/test_data")


@pytest.fixture
def test_data():
    return REFERENCE


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided here, at test time, never while
    a module is imported (test workers must collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is {dev.platform}")
    return dev
