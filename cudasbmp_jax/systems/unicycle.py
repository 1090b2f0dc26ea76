"""Differential-drive unicycle — velocity/turn-rate controlled planar robot.

Not in the reference (which hardcodes one bicycle system,
statePropagator.cu:31-48); included because the systems registry makes new
dynamics a drop-in (the intent behind the reference's empty systems/car.yaml).
State (x, y, theta, 0); controls (v, omega) plus duration:

    x     += v * cos(theta) * dt        # pre-step theta, like the bicycle
    y     += v * sin(theta) * dt
    theta += omega * dt

The 4th state slot is zero-padded so the shared 7-float sample layout
(SAMPLE_DIM, State.h:13-19) holds for every system.
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
class Unicycle:
    name: str = "unicycle"
    state_dim: int = 4
    heading_index: ClassVar[int] = 2
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(
            lo=(-2.0, -math.pi, 0.05),
            hi=(2.0, math.pi, 1.05),
        )
    )

    def step(self, state: Array, control: Array, dt: Array) -> Array:
        x, y, theta = (state[..., i] for i in range(3))
        v, omega = control[..., 0], control[..., 1]
        new_x = x + v * jnp.cos(theta) * dt
        new_y = y + v * jnp.sin(theta) * dt
        new_theta = theta + omega * dt
        return jnp.stack(
            [new_x, new_y, new_theta, jnp.zeros_like(new_x)], axis=-1
        )

    # -- fused-kernel SoA hooks (systems.base.SoAStepMixin) ---------------
    def soa_prepare(self, ctrl: list[Array]) -> tuple[Array, ...]:
        v, omega = ctrl
        return v, omega

    def soa_step(self, comps: list[Array], aux: tuple[Array, ...],
                 dt: Array) -> list[Array]:
        x, y, th, z = comps
        v, omega = aux
        return [x + v * jnp.cos(th) * dt,
                y + v * jnp.sin(th) * dt,
                th + omega * dt,
                jnp.zeros_like(z)]

    # -- fast-math hooks (see systems.base): dtheta = omega*dt is CONSTANT
    # per rollout, so one rotation per step replaces cos+sin. ---------------
    def soa_prepare_fast(self, comps, ctrl, dt):
        v, omega = ctrl
        _, _, th, _ = comps
        d0 = omega * dt
        carry = (jnp.cos(th), jnp.sin(th))
        aux = (v, omega, jnp.cos(d0), jnp.sin(d0))
        return carry, aux

    def soa_step_fast(self, comps, carry, aux, dt):
        x, y, th, z = comps
        ct, st = carry
        v, omega, dct, dst = aux
        new = [x + v * ct * dt,
               y + v * st * dt,
               th + omega * dt,
               jnp.zeros_like(z)]
        return new, (ct * dct - st * dst, st * dct + ct * dst)
