"""Test harness: CPU backend with 8 virtual devices (sharding tests) + x64.

Mirrors the serial-vs-MPI cross-check strategy of the reference (SURVEY.md §4)
on a virtual mesh: every sharded code path must reproduce the single-device
result to f64 roundoff.

Unit tests run on the CPU even on a machine with a GPU: the platform is set
here, after importing jax but before any backend initialization
(``JAX_PLATFORMS=cpu`` in the environment does the same). Tests marked
``gpu`` need the card; they run with ``python -m pytest -m gpu tests/`` on a
GPU machine, where the ``gpu_device`` fixture leaves JAX's platform alone.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    # a run that selects exactly the card-only tests keeps JAX's own
    # platform choice; every other run is pinned to the CPU
    if (config.getoption("markexpr", "") or "").strip() == "gpu":
        return
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first JAX device, which must be a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m gpu "
                    "tests/` on a GPU machine")
    return dev
