"""cudasbmp_jax — a JAX kinodynamic sampling-based motion-planning engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the CUDA reference
``nipe1783/cudaSBMP`` (see SURVEY.md): the KGMT frontier-parallel kinodynamic tree
search with adaptive two-level (R1/R2) region guidance, batched random-control
rollouts with fused Euler integration + swept-AABB collision checking, plus the
surrounding framework the reference implies (systems registry, scenario IO,
benchmark probes, checkpointing, mesh-parallel multi-query / Monte-Carlo planning).

Nothing here is a port: the planner iteration is a pure fixed-shape function
``PlannerState -> PlannerState`` driven by ``lax.while_loop`` under one ``jax.jit``;
stream compaction is cumsum-scatter; atomics are segment-sums; curand states are
``jax.random.fold_in`` keys; multi-device scale is a ``jax.sharding.Mesh``.
"""

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.planners.kgmt import KGMT, KGMTResult

__version__ = "0.1.0"

__all__ = ["KGMTConfig", "Scenario", "KGMT", "KGMTResult", "__version__"]


def __getattr__(name):
    # lazy heavy extras: refinement / shortcutting stages (single-path and
    # whole-batch forms)
    if name in ("refine_path", "refine_batch"):
        import cudasbmp_jax.refine as _m

        return getattr(_m, name)
    if name in ("shortcut_path", "shortcut_batch"):
        import cudasbmp_jax.shortcut as _m

        return getattr(_m, name)
    raise AttributeError(name)
