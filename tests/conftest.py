"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real device
count (1 CPU); only launch/dryrun.py forces 512 host devices."""
import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="run slow tests (subprocess dry-runs etc.)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip = pytest.mark.skip(reason="needs --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow tests (subprocess)")
    config.addinivalue_line(
        "markers", "kernels: Pallas kernel sweeps (excluded from fast CI)")
    config.addinivalue_line(
        "markers", "system: end-to-end system tests (excluded from fast CI)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skipped without one")
