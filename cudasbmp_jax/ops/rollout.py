"""Batched propagate-and-check: the system's single hot inner function.

Batched re-expression of the reference's per-thread ``propagateAndCheck``
(statePropagator.cu:5-76): where the reference rolls out one random control per
CUDA thread with an early-exit loop, here a dense batch of B rollouts advances
in lockstep — ``lax.scan`` over the ``num_disc`` Euler steps, all-lanes-active
with an ``alive`` mask instead of ``break``; each step integrates, tests the
workspace bounds and reduces the swept-AABB obstacle tests
(collisionCheck.cu:6-28). This is the plain reference and the path off the
GPU; on the GPU the planner runs the fused kernel of ``rollout_pallas.py``,
which computes the same float operations in one launch.

Break-semantics parity: the reference stops integrating at the first invalid
step and stores the state reached *at* that step (position already advanced,
theta/v rolled back only on the bounds branch). Masked lockstep freezes the
carried state at exactly the failing step's candidate, so valid rollouts match
bitwise-in-float and invalid rollouts expose the same final position to the
region-statistics pass. (theta/v of invalid rollouts are unobservable: invalid
samples never enter the tree and stats use position only.)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cudasbmp_jax.geometry.aabb import segment_aabb, segment_clear
from cudasbmp_jax.geometry.footprint import footprint_clear
from cudasbmp_jax.systems.base import System
from cudasbmp_jax.utils.vma import pvary_like

Array = jax.Array


def rollout_batch(
    system: System,
    x0: Array,  # [B, state_dim] start states
    controls: Array,  # [B, control_dim] sampled controls, duration LAST
    num_disc: int,
    obstacles: Array,  # [K, 4] AABBs (padding rows may be degenerate)
    width: float,
    height: float,
    footprint: tuple[float, float] | None = None,
) -> tuple[Array, Array]:
    """Integrate B rollouts for num_disc steps with per-step validity checks.

    With ``footprint=(half_len, half_wid)`` the narrow-phase oriented-body
    test (geometry/footprint.py, beyond-reference) runs at every post-step
    pose IN ADDITION to the reference's point-swept broad phase: a step is
    invalid if the swept center segment's AABB hits an obstacle (tunneling
    guard, exact reference semantics) OR the agent's rectangle at the new
    pose does. The body heading comes from ``system.heading_index`` (0.0 —
    axis-aligned — for systems without one).

    Returns (x1, valid): final states [B, state_dim] (frozen at the failing
    step for invalid rollouts) and the motion-valid mask [B].
    """
    duration = controls[:, -1]
    ctrl = controls[:, :-1]
    dt = duration / num_disc
    heading_index = getattr(system, "heading_index", None)

    def step(carry, _):
        state, alive = carry
        cand = system.step(state, ctrl, dt)
        x, y = cand[:, 0], cand[:, 1]
        # Workspace bounds are exclusive (statePropagator.cu:42-45).
        in_bounds = (x > 0.0) & (x < width) & (y > 0.0) & (y < height)
        # Swept AABB of this step's motion segment vs every obstacle
        # (statePropagator.cu:49-61).
        bb_min, bb_max = segment_aabb(state[:, 0:2], cand[:, 0:2])
        clear = segment_clear(bb_min, bb_max, obstacles)
        step_ok = in_bounds & clear
        if footprint is not None:
            theta = (cand[:, heading_index] if heading_index is not None
                     else jnp.zeros_like(x))
            step_ok = step_ok & footprint_clear(
                x, y, theta, footprint[0], footprint[1], obstacles
            )
        new_state = jnp.where(alive[:, None], cand, state)
        new_alive = alive & step_ok
        return (new_state, new_alive), None

    # under shard_map the carry's alive mask must start with the same
    # varying-axes type the body produces (utils/vma.py); no-op otherwise
    alive0 = pvary_like(jnp.ones(x0.shape[0], bool), x0, controls, obstacles)
    (x1, valid), _ = jax.lax.scan(step, (x0, alive0), None, length=num_disc)
    return x1, valid


def rollout_unchecked(
    system: System,
    x0: Array,  # [B, state_dim]
    controls: Array,  # [B, control_dim], duration last
    num_disc: int,
) -> Array:
    """Pure propagation with NO validity checks — the probe planners' path.

    The reference's Naive/CostProp kernels integrate without any bounds or
    collision tests (NaivePlanner.cu:26-48, CostPropPlanner.cu:26-58);
    rollout_batch's bounds test would instead freeze rollouts crossing
    x<=0 / y<=0 and skew the throughput-probe semantics. Returns x1 [B, d].
    """
    duration = controls[:, -1]
    ctrl = controls[:, :-1]
    dt = duration / num_disc

    def step(state, _):
        return system.step(state, ctrl, dt), None

    x1, _ = jax.lax.scan(step, x0, None, length=num_disc)
    return x1


@partial(jax.jit, static_argnames=("system", "num_disc", "width", "height", "batch"))
def propagate_and_check(
    system: System,
    key: Array,
    x0: Array,  # [B, state_dim]
    obstacles: Array,
    *,
    num_disc: int,
    width: float,
    height: float,
    batch: int | None = None,
) -> tuple[Array, Array, Array]:
    """Sample random controls and roll them out — the full analog of the
    reference's propagateAndCheck including control sampling
    (statePropagator.cu:17-19), but over a batch and with counter-based RNG
    instead of persistent curand states (KGMT.cu:109-111; we are deterministic
    by construction).

    Returns (samples, controls, valid): samples [B, state_dim + control_dim]
    is final-state-plus-producing-control, the tree/sample layout the whole
    pipeline shares (statePropagator.cu:67-73).
    """
    B = x0.shape[0] if batch is None else batch
    controls = system.control_spec.sample(key, (B,))
    x1, valid = rollout_batch(system, x0, controls, num_disc, obstacles, width, height)
    samples = jnp.concatenate([x1, controls], axis=-1)
    return samples, controls, valid
