import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
