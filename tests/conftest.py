"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; only launch/dryrun.py forces 512."""

import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips on the CPU")
