"""2-D point agent (velocity-controlled), for BASELINE.json config 1.

The reference has no second system but BASELINE.json's measurement config 1
calls for a "2D point agent in R2 workspace ... CPU-runnable". State is
(x, y, 0, 0) padded to the 4-dim state layout so all planner code is shared.
Controls: velocity components vx, vy plus duration.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cudasbmp_jax.systems.base import ControlSpec

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class Point2D:
    name: str = "point2d"
    state_dim: int = 4
    max_speed: float = 2.0
    # None -> derived from max_speed in __post_init__, so the two can never
    # disagree (round-1 review: a hardcoded spec made max_speed dead config).
    control_spec: ControlSpec | None = None

    def __post_init__(self) -> None:
        if self.control_spec is None:
            object.__setattr__(
                self,
                "control_spec",
                ControlSpec(
                    lo=(-self.max_speed, -self.max_speed, 0.05),
                    hi=(self.max_speed, self.max_speed, 1.05),
                ),
            )

    def step(self, state: Array, control: Array, dt: Array) -> Array:
        x, y = state[..., 0], state[..., 1]
        vx, vy = control[..., 0], control[..., 1]
        new_x = x + vx * dt
        new_y = y + vy * dt
        zeros = jnp.zeros_like(new_x)
        return jnp.stack([new_x, new_y, zeros, zeros], axis=-1)

    # -- fused-kernel SoA hooks (systems.base.SoAStepMixin) ---------------
    def soa_prepare(self, ctrl: list[Array]) -> tuple[Array, ...]:
        vx, vy = ctrl
        return vx, vy

    def soa_step(self, comps: list[Array], aux: tuple[Array, ...],
                 dt: Array) -> list[Array]:
        x, y, z0, z1 = comps
        vx, vy = aux
        return [x + vx * dt, y + vy * dt, jnp.zeros_like(z0),
                jnp.zeros_like(z1)]
