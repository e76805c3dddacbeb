"""Test harness: force an 8-device virtual CPU mesh BEFORE importing jax so
multi-device sharding logic is testable without cards (SURVEY.md §4d).

Tests that need a GPU carry the ``gpu`` marker and the ``gpu_device``
fixture, which skips them here. ``chip_smoke.py`` runs them on the card
in its own process with ``XRT_TESTS_ON_GPU=1``, which leaves the backend
as JAX found it.
"""

import os
import sys

import pytest

ON_GPU = os.environ.get("XRT_TESTS_ON_GPU") == "1"

if not ON_GPU:
    # FORCE (not setdefault): the suite runs on the virtual CPU mesh
    # whatever the environment exports
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
if not ON_GPU:
    # config updates before the first backend use are authoritative;
    # jax_num_cpu_devices is the supported way to get the 8-device mesh
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(
            f"needs a GPU; JAX runs on {devs[0].platform} here "
            "(chip_smoke.py runs the gpu-marked tests on the card)"
        )
    return devs[0]
