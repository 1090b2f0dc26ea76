"""2-D double integrator — acceleration-controlled point mass.

Not in the reference; included to demonstrate the systems registry is real
(planners are generic over dynamics). State (x, y, vx, vy); controls (ax, ay)
plus duration.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cudasbmp_jax.systems.base import ControlSpec

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class DoubleIntegrator2D:
    name: str = "double_integrator"
    state_dim: int = 4
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(
            lo=(-3.0, -3.0, 0.05),
            hi=(3.0, 3.0, 1.05),
        )
    )

    def step(self, state: Array, control: Array, dt: Array) -> Array:
        x, y, vx, vy = (state[..., i] for i in range(4))
        ax, ay = control[..., 0], control[..., 1]
        # Position integrates PRE-step velocity (same convention as bicycle).
        new_x = x + vx * dt
        new_y = y + vy * dt
        new_vx = vx + ax * dt
        new_vy = vy + ay * dt
        return jnp.stack([new_x, new_y, new_vx, new_vy], axis=-1)

    # -- fused-kernel SoA hooks (systems.base.SoAStepMixin) ---------------
    def soa_prepare(self, ctrl: list[Array]) -> tuple[Array, ...]:
        ax, ay = ctrl
        return ax, ay

    def soa_step(self, comps: list[Array], aux: tuple[Array, ...],
                 dt: Array) -> list[Array]:
        x, y, vx, vy = comps
        ax, ay = aux
        return [x + vx * dt, y + vy * dt, vx + ax * dt, vy + ay * dt]
