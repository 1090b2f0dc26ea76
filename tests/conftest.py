"""Test harness. Run the CPU suite with ``JAX_PLATFORMS=cpu``; the flag
below gives the CPU platform 8 virtual devices for the mesh tests (SURVEY.md
§4.4). Tests marked ``gpu`` take the ``gpu`` fixture and skip unless JAX's
default backend is a GPU: ``python -m pytest tests/ -m gpu`` on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cudasbmp_jax.config import KGMTConfig, Scenario  # noqa: E402


@pytest.fixture(scope="session")
def demo_scenario() -> Scenario:
    return Scenario.demo()


@pytest.fixture(scope="session")
def small_config() -> KGMTConfig:
    """A scaled-down config that solves fast on CPU."""
    return KGMTConfig(
        num_iterations=100,
        max_tree_size=16384,
        rollouts_per_iter=2048,
        seed=0,
    )


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided when the test runs,
    never at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; the default backend is "
                    f"{jax.default_backend()!r}")
