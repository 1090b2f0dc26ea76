"""Kinematic bicycle ("car") — the reference's only real system.

Semantics match ``propagateAndCheck`` (statePropagator.cu:31-48), the host
duplicate ``Agent::updateState`` (Agent.cpp:19-25) and the MATLAB
re-integration (visualizationKGMT_Single.m:93-112):

    x     += v * cos(theta) * dt        # uses PRE-step theta, v
    y     += v * sin(theta) * dt
    theta += (v / L) * tan(steering) * dt
    v     += a * dt

Control sampling ranges follow the reference *code* (the comments there are
stale — SURVEY.md §2.4.3): a ~ U(-5, 5), steering ~ U(-pi, pi),
duration ~ U(0.05, 1.05) (statePropagator.cu:17-19).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar
import math

import jax
import jax.numpy as jnp

from cudasbmp_jax.systems.base import ControlSpec

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class KinematicBicycle:
    name: str = "bicycle"
    state_dim: int = 4  # x, y, theta, v   (STATE_DIM, KGMT.cu:6)
    heading_index: ClassVar[int] = 2  # theta component (footprint narrow phase)
    agent_length: float = 1.0  # wheelbase L (demos/main.cu:26)
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(
            lo=(-5.0, -math.pi, 0.05),
            hi=(5.0, math.pi, 1.05),
        )
    )

    def step(self, state: Array, control: Array, dt: Array) -> Array:
        x, y, theta, v = (state[..., i] for i in range(4))
        a, steering = control[..., 0], control[..., 1]
        new_x = x + v * jnp.cos(theta) * dt
        new_y = y + v * jnp.sin(theta) * dt
        new_theta = theta + (v / self.agent_length) * jnp.tan(steering) * dt
        new_v = v + a * dt
        return jnp.stack([new_x, new_y, new_theta, new_v], axis=-1)

    # -- fused-kernel SoA hooks (systems.base.SoAStepMixin) ---------------
    def soa_prepare(self, ctrl: list[Array]) -> tuple[Array, ...]:
        a, steering = ctrl
        # loop-invariant steering tangent hoisted (the reference recomputes
        # tan every step, statePropagator.cu:36). Kept UNscaled so soa_step's
        # op order matches step() bitwise — (v/L)*tan*dt, not v*(tan/L)*dt —
        # which the cross-backend valid-mask parity tests rely on.
        return a, jnp.tan(steering)

    def soa_step(self, comps: list[Array], aux: tuple[Array, ...],
                 dt: Array) -> list[Array]:
        x, y, th, v = comps
        a, tan_s = aux
        return [x + v * jnp.cos(th) * dt,
                y + v * jnp.sin(th) * dt,
                th + (v / self.agent_length) * tan_s * dt,
                v + a * dt]

    # -- fast-math hooks (see systems.base): dtheta_k = (v_k/L)*tan(s)*dt
    # with v_k = v0 + a*dt*k is AFFINE in k, so both cos/sin(theta) and
    # cos/sin(dtheta) update by one 2-D rotation per step. 7 transcendentals
    # once per rollout (tan, 3x cos, 3x sin) replace 2 per step. -----------
    def soa_prepare_fast(self, comps, ctrl, dt):
        a, steering = ctrl
        tan_s = jnp.tan(steering)
        _, _, th, v = comps
        d0 = (v / self.agent_length) * tan_s * dt  # dtheta at step 0
        c2 = (a * dt / self.agent_length) * tan_s * dt  # per-step increment
        carry = (jnp.cos(th), jnp.sin(th), jnp.cos(d0), jnp.sin(d0), d0)
        aux = (a, jnp.cos(c2), jnp.sin(c2), c2)
        return carry, aux

    def soa_step_fast(self, comps, carry, aux, dt):
        x, y, th, v = comps
        ct, st, dct, dst, dth = carry
        a, cc2, sc2, c2 = aux
        # position uses PRE-step theta (= ct/st) and v, like step()
        new = [x + v * ct * dt,
               y + v * st * dt,
               th + dth,
               v + a * dt]
        nct = ct * dct - st * dst
        nst = st * dct + ct * dst
        ndct = dct * cc2 - dst * sc2
        ndst = dst * cc2 + dct * sc2
        return new, (nct, nst, ndct, ndst, dth + c2)
