"""Test configuration: CPU backend with 8 virtual devices, f64 enabled.

Multi-device sharding is validated on a virtual CPU mesh (8 host devices),
the strategy the reference never needs (it is single-threaded) but the
distributed layer requires. f64 is enabled to meet the reference tolerances
(property tests at 5e-9, polynomial exactness at 1e-12 — reference
``src/algorithms/mod.rs:360``, ``tests/correctness.rs:42-51``).

The CPU is pinned unless ``JAX_PLATFORMS`` names another platform: the
card-only tests (marker ``gpu``) run on a GPU with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``. Whether a card is
present is decided by the ``gpu`` fixture at test time; elsewhere those
tests skip.
"""

import os

import jax

if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/ on a machine with a card")
