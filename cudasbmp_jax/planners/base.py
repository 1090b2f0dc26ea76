"""Planner interface.

The reference declares an abstract ``Planner`` base with ``plan`` and
``generateRandomTree`` (include/planners/Planner.cuh:6-12) which its flagship
KGMT then bypasses (SURVEY.md §1). Here the interface is honored by every
planner, including the flagship.
"""

from __future__ import annotations

import abc
from typing import Any

from cudasbmp_jax.config import Scenario


class Planner(abc.ABC):
    """A motion planner over a fixed scenario family."""

    @abc.abstractmethod
    def plan(self, scenario: Scenario) -> Any:
        """Solve one planning problem; returns a planner-specific result."""

    @abc.abstractmethod
    def generate_random_tree(self, scenario: Scenario, num_rollouts: int) -> Any:
        """Grow a random tree without guidance — the reference's raw
        propagation-throughput probe (Planner.cuh:10)."""
