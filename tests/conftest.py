"""Test config: force a fake 8-device CPU backend (SURVEY.md §4.6).

Must set env vars before jax initializes, hence module level here. On
the CPU every Pallas kernel runs in the interpreter. SURFJAX_TEST_GPU=1
leaves the platform to JAX instead, for the tests marked `gpu`:

    SURFJAX_TEST_GPU=1 python -m pytest -m gpu tests/
"""

import os

if not os.environ.get("SURFJAX_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled Triton kernels); "
        "skips elsewhere")


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run SURFJAX_TEST_GPU=1 python -m pytest "
                    "-m gpu tests/ on a machine with a card")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules (r5).

    The full suite accumulates ~180 tests' jitted programs in one
    process; at that pressure the largest interpret-mode pallas compile
    (test_mesh's AO+soft-shadow frame) segfaulted inside XLA:CPU
    compile/deserialize REPRODUCIBLY, while the same test solo passes.
    Clearing per module bounds live executable memory; cross-module
    recompiles are persistent-cache hits (fast) where the cache is on.
    """
    yield
    jax.clear_caches()
