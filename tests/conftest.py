import os

# Tests run on the single real CPU device. (The dry-run forces 512 fake
# devices itself, in a subprocess — never here.)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the PyTorch port's CUDA "
        "kernels); skipped without one")
