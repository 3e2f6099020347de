"""Shared test fixtures. NOTE: no XLA_FLAGS here by design -- smoke tests
and benches must see 1 device; multi-device tests spawn subprocesses.

Test tiers: the default run skips tests marked ``@pytest.mark.slow`` (the
exhaustive kernel sweeps), keeping tier-1 fast; run the slow tier with
``-m slow`` (or everything with ``-m "slow or not slow"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: exhaustive sweeps excluded from the fast tier-1 run"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA kernels); skips without one"
    )
    # Default to the fast tier: equivalent of addopts = -m "not slow", but
    # kept here so the repo needs no ini file and -m on the CLI still wins.
    # Explicit node ids (path::test) bypass the default so a slow test can
    # be run by naming it, without remembering -m slow.
    if not config.option.markexpr and not any("::" in a for a in config.args):
        config.option.markexpr = "not slow"


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def assert_allclose(a, b, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=rtol,
        err_msg=msg,
    )


def rand(key, shape, dtype=jnp.float32):
    return jax.random.normal(key, shape, dtype)
