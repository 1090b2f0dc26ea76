"""Dynamical-system interface.

The reference hardcodes one system — the kinematic bicycle inside
``propagateAndCheck`` (statePropagator.cu:5-76), duplicated on the host in
``Agent::updateState`` (Agent.cpp:19-25) — and ships an *empty*
``systems/car.yaml`` whose evident intent was a declarative system description.
Here systems are first-class: a pure, vmap-able Euler step plus a declarative
control-sampling spec, so planners are generic over dynamics.

State convention (matches the reference's sample layout, State.h:13-19):
    position  = state[..., :2]       (x, y) — what collision/grid logic sees
    remainder = system-specific (theta, v, ...) padded to ``state_dim``.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import jax
import jax.numpy as jnp

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    """Uniform box control distribution + duration range.

    The reference samples accel ~ U(-5, 5), steering ~ U(-pi, pi),
    duration ~ U(0.05, 1.05) (statePropagator.cu:17-19; the comments there
    disagree with the code — the code wins, SURVEY.md §2.4.3).
    """

    lo: tuple[float, ...]  # per-control-dim lower bounds (duration last)
    hi: tuple[float, ...]  # per-control-dim upper bounds (duration last)

    @property
    def dim(self) -> int:
        return len(self.lo)

    def sample(self, key: Array, shape: tuple[int, ...] = ()) -> Array:
        """Sample controls uniformly; returns [..., dim] with duration last."""
        lo = jnp.asarray(self.lo, jnp.float32)
        hi = jnp.asarray(self.hi, jnp.float32)
        u = jax.random.uniform(key, shape + (self.dim,), jnp.float32)
        return lo + u * (hi - lo)


@runtime_checkable
class System(Protocol):
    """A controlled dynamical system with an explicit-Euler step.

    Implementations must be pure pytrees of static config so they can be
    closed over by jitted planner code.
    """

    name: str
    state_dim: int  # dynamic state dims (>= 2; first two are x, y)
    control_spec: ControlSpec  # includes duration as the last dim

    def step(self, state: Array, control: Array, dt: Array) -> Array:
        """One Euler step. state [..., state_dim], control [..., control_dim-1]
        (duration excluded — it only sets dt), dt broadcastable. Pure."""
        ...


class SoAStepMixin(Protocol):
    """Optional structure-of-arrays step hooks that admit a system to the
    fused Pallas rollout kernel (ops/rollout_pallas.py).

    The kernel holds each state/control component as its own 1-D block of
    lanes in registers; ``soa_prepare`` runs ONCE per rollout (hoist
    loop-invariant work, e.g. the bicycle's tan(steering)) and ``soa_step``
    runs per Euler step on component lists. Components [0], [1] must be
    workspace x, y. Semantics must match ``step`` (parity-tested in
    tests/test_pallas.py).
    """

    def soa_prepare(self, ctrl: list[Array]) -> tuple[Array, ...]:
        """Per-rollout precomputation from non-duration control components."""
        ...

    def soa_step(self, comps: list[Array], aux: tuple[Array, ...],
                 dt: Array) -> list[Array]:
        """One Euler step on per-component arrays; returns new components."""
        ...

    # -- optional fast-math hooks (KGMTConfig.fast_math) -------------------
    # Systems whose per-step transcendentals admit a recurrence may ALSO
    # provide the pair below; the fused kernel then replaces per-step
    # cos/sin with chained 2-D rotations (+6.7 % raw-probe rollouts/s on an
    # H100 at 400 W, PERF.md): dtheta_k is affine in the step index, so
    # cos/sin(theta_k) and cos/sin(dtheta_k) each update with one rotation —
    # 8 mul + 4 add instead of 2 transcendentals per step. Positions then
    # differ from the
    # exact path only by f32 rounding accumulation (~1e-6 over num_disc=10);
    # valid masks may flip on boundary-grazing rollouts. CONTRACT: when the
    # system has a heading, carry[0] and carry[1] must be
    # (cos(theta), sin(theta)) of the CURRENT state so the footprint narrow
    # phase can reuse them.
    #
    # def soa_prepare_fast(self, comps, ctrl, dt) -> tuple[carry, aux]
    # def soa_step_fast(self, comps, carry, aux, dt) -> tuple[new_comps,
    #                                                         new_carry]
