"""Test configuration: the CPU backend with 8 virtual devices.

All sharding tests run on ``--xla_force_host_platform_device_count=8``
virtual CPU devices.  Tests that need a GPU carry the ``gpu`` marker and take
the ``gpu_device`` fixture, which skips them on the CPU.  On a machine with
the card, ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them;
``python chip_smoke.py`` runs the same checks as its phases.
"""
import os

_PLATFORM = "cuda" if os.environ.get("JAX_PLATFORMS") in ("cuda", "gpu") else "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORM
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", _PLATFORM)

import rgc_slam_tpu  # noqa: E402,F401  (sets the package's jax config)

# CPU executables stay out of the checkout's persistent compile cache
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture()
def rng():
    """Function-scoped on purpose: a session-scoped generator makes every
    consumer's draws depend on which tests ran before it, so any subset run
    (-m "not slow", -k, a lone file) sees different numbers than the full
    pyramid — the round-3 advisor caught a tolerance-edge test flipping
    exactly this way.  Fresh seed-42 stream per test = order-independent."""
    return np.random.default_rng(42)


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return gpus[0]
