"""Test configuration: run the suite on a virtual 8-device CPU mesh so
sharding paths are exercised without accelerators. The platform is
forced through jax.config before any backend initialization, so the
suite runs on the CPU even where a GPU is attached.

Tests that need a GPU take the `gpu` fixture: it decides at run time,
never at import, so every pytest-xdist worker collects the same tests.
They skip on the CPU-only suite; run them on a GPU machine with
`python -m pytest tests/ -m gpu -p no:xdist --gpu`.
"""

import jax
import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true", default=False,
                     help="run the suite on the GPU (gpu-marked tests)")


def pytest_configure(config):
    if not config.getoption("--gpu"):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest tests/ "
                    "-m gpu -p no:xdist --gpu` on a GPU machine")
