"""Dubins-style curvature car — forward-only speed, bounded curvature.

Not in the reference; a third vehicle family exercising the registry. State
(x, y, theta, 0); controls (v, kappa) plus duration, with v sampled forward-
only (v_min > 0) and the heading rate proportional to speed times curvature
(the defining Dubins property — the turn radius 1/|kappa| is speed-invariant):

    x     += v * cos(theta) * dt        # pre-step theta
    y     += v * sin(theta) * dt
    theta += v * kappa * dt

With kappa in [-kappa_max, kappa_max] the minimum turn radius is
1/kappa_max, independent of the sampled speed.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import jax
import jax.numpy as jnp

from cudasbmp_jax.systems.base import ControlSpec

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class DubinsCar:
    name: str = "dubins"
    state_dim: int = 4
    heading_index: ClassVar[int] = 2
    kappa_max: float = 1.0  # min turn radius = 1 / kappa_max
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(
            lo=(0.25, -1.0, 0.05),
            hi=(2.0, 1.0, 1.05),
        )
    )

    def step(self, state: Array, control: Array, dt: Array) -> Array:
        x, y, theta = (state[..., i] for i in range(3))
        v, kappa = control[..., 0], control[..., 1]
        new_x = x + v * jnp.cos(theta) * dt
        new_y = y + v * jnp.sin(theta) * dt
        new_theta = theta + v * kappa * dt
        return jnp.stack(
            [new_x, new_y, new_theta, jnp.zeros_like(new_x)], axis=-1
        )

    # -- fused-kernel SoA hooks (systems.base.SoAStepMixin) ---------------
    def soa_prepare(self, ctrl: list[Array]) -> tuple[Array, ...]:
        v, kappa = ctrl
        return v, kappa

    def soa_step(self, comps: list[Array], aux: tuple[Array, ...],
                 dt: Array) -> list[Array]:
        x, y, th, z = comps
        v, kappa = aux
        return [x + v * jnp.cos(th) * dt,
                y + v * jnp.sin(th) * dt,
                th + v * kappa * dt,
                jnp.zeros_like(z)]

    # -- fast-math hooks (see systems.base): v is constant per rollout, so
    # dtheta = v*kappa*dt is constant — one rotation per step. --------------
    def soa_prepare_fast(self, comps, ctrl, dt):
        v, kappa = ctrl
        _, _, th, _ = comps
        d0 = v * kappa * dt
        carry = (jnp.cos(th), jnp.sin(th))
        aux = (v, kappa, jnp.cos(d0), jnp.sin(d0))
        return carry, aux

    def soa_step_fast(self, comps, carry, aux, dt):
        x, y, th, z = comps
        ct, st = carry
        v, kappa, dct, dst = aux
        new = [x + v * ct * dt,
               y + v * st * dt,
               th + v * kappa * dt,
               jnp.zeros_like(z)]
        return new, (ct * dct - st * dst, st * dct + ct * dst)
