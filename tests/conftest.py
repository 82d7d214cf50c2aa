"""Test environment: JAX on a virtual 8-device CPU mesh unless the caller
pins a platform; fixtures for the reference checkout's data; the `gpu`
marker.

Must run before any jax import (session-scoped env setup)."""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REFERENCE_DIR = os.environ.get("NTLINK_REFERENCE_DIR", "/root/reference")
GOLDEN_DIR = os.path.join(REFERENCE_DIR, "tests", "expected_outputs")
REF_TESTS_DIR = os.path.join(REFERENCE_DIR, "tests")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda pytest -m gpu)",
    )


@pytest.fixture
def ref_tests_dir():
    """The reference checkout's test inputs; skips when not mounted."""
    if not os.path.isdir(REF_TESTS_DIR):
        pytest.skip("reference test data not available")
    return REF_TESTS_DIR


@pytest.fixture
def golden_dir(ref_tests_dir):
    """The reference's expected outputs; skips when not mounted."""
    if not os.path.isdir(GOLDEN_DIR):
        pytest.skip("reference goldens not available")
    return GOLDEN_DIR


@pytest.fixture
def gpu_device():
    """The first GPU device; skips when JAX sees none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("no GPU visible to JAX")
    return gpus[0]
