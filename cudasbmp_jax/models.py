"""Host-side problem/data model: Sample and Agent.

Parity layer for the reference's host model classes (SURVEY.md §2.1 L5):

- ``Sample`` mirrors ``State`` (include/state/State.h:6-20): the 7-field
  (x, y, theta, v, a, steering, duration) record that IS the tree-row layout
  everywhere in the engine — here with conversion to/from the packed float
  array instead of being dead code.
- ``Agent`` mirrors ``Agent`` (include/agent/Agent.h:6-26 /
  src/agent/Agent.cpp): kinematic-bicycle pose + a rectangular CCW footprint,
  with ``update_state`` delegating to the single source of dynamics truth
  (systems.bicycle) instead of duplicating the equations as the reference
  does (its host Agent and device propagator carry two copies).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from cudasbmp_jax.config import SAMPLE_DIM
from cudasbmp_jax.systems.bicycle import KinematicBicycle


@dataclasses.dataclass
class Sample:
    """One tree sample: final state + the control that produced it."""

    x: float = 0.0
    y: float = 0.0
    theta: float = 0.0
    v: float = 0.0
    a: float = 0.0
    steering: float = 0.0
    duration: float = 0.0

    def to_array(self) -> np.ndarray:
        return np.array(
            [self.x, self.y, self.theta, self.v, self.a, self.steering,
             self.duration],
            np.float32,
        )

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Sample":
        arr = np.asarray(arr, np.float32).reshape(-1)
        assert arr.shape[0] >= SAMPLE_DIM
        return cls(*map(float, arr[:SAMPLE_DIM]))

    @property
    def state(self) -> np.ndarray:
        return np.array([self.x, self.y, self.theta, self.v], np.float32)

    @property
    def control(self) -> np.ndarray:
        return np.array([self.a, self.steering, self.duration], np.float32)


@dataclasses.dataclass
class Agent:
    """Host-side kinematic bicycle with a rectangular footprint."""

    x: float = 0.0
    y: float = 0.0
    theta: float = 0.0
    v: float = 0.0
    length: float = 1.0  # wheelbase
    width: float = 0.5

    _system: KinematicBicycle = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self._system is None or self._system.agent_length != self.length:
            self._system = KinematicBicycle(agent_length=self.length)

    def update_state(self, a: float, delta: float, dt: float) -> None:
        """One Euler step — same semantics as Agent::updateState
        (Agent.cpp:19-25), computed by the shared systems.bicycle step."""
        import jax.numpy as jnp

        state = jnp.array([self.x, self.y, self.theta, self.v])
        control = jnp.array([a, delta])
        out = np.asarray(self._system.step(state, control, jnp.float32(dt)))
        self.x, self.y, self.theta, self.v = map(float, out)

    def footprint_ccw(self) -> np.ndarray:
        """CCW rectangle vertices of the agent at its current pose: the
        wheelbase-long, ``width``-wide body centered on the rear axle and
        rotated by theta. (The reference constructs an axis-aligned square
        and never rotates it, Agent.cpp:6-17 — the rotation is the evident
        intent.) Returns [4, 2]."""
        c, s = math.cos(self.theta), math.sin(self.theta)
        local = np.array(
            [
                [0.0, -self.width / 2],
                [self.length, -self.width / 2],
                [self.length, self.width / 2],
                [0.0, self.width / 2],
            ]
        )
        rot = np.array([[c, -s], [s, c]])
        return local @ rot.T + np.array([self.x, self.y])
