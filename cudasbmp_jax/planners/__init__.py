from cudasbmp_jax.planners.base import Planner
from cudasbmp_jax.planners.kgmt import (
    KGMT,
    KGMTResult,
    KGMTState,
    PathlessState,
)
from cudasbmp_jax.planners.naive import NaivePlanner
from cudasbmp_jax.planners.costprop import CostPropPlanner

__all__ = [
    "Planner",
    "KGMT",
    "KGMTResult",
    "KGMTState",
    "PathlessState",
    "NaivePlanner",
    "CostPropPlanner",
]
