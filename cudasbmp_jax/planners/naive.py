"""Naive random-tree probe — the reference's earliest prototype
(src/planners/NaivePlanner.cu), kept as a raw propagation-throughput probe.

Reference behavior: 32x32 threads x 10 rows of kinematic-bicycle rollouts from
the root with NO collision checking, narrower control ranges than KGMT
(a ~ U(-2.5, 2.5), steering ~ U(-pi/2, pi/2), duration ~ U(0, 0.3) —
NaivePlanner.cu:31-35), 20 Euler steps, kernel-ms timing. Its row-chaining
reads parents out of bounds from the 7-float root buffer
(NaivePlanner.cu:68-72 — SURVEY.md §2.4.8), so the evident intent — every row
propagates from the root — is what this implements.
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.ops.rollout import rollout_unchecked
from cudasbmp_jax.planners.base import Planner
from cudasbmp_jax.systems.base import ControlSpec
from cudasbmp_jax.systems.registry import get_system

PROBE_CONTROL_SPEC = ControlSpec(
    lo=(-2.5, -math.pi / 2, 0.0),
    hi=(2.5, math.pi / 2, 0.3),
)
PROBE_NUM_DISC = 20  # NaivePlanner.cu:70 / CostPropPlanner.cu:74 pass 20


@dataclasses.dataclass
class ProbeResult:
    samples: np.ndarray  # [rows, width, SAMPLE_DIM]
    num_rollouts: int
    kernel_time_s: float  # device time for the propagation only
    rollouts_per_sec: float


class NaivePlanner(Planner):
    def __init__(self, config: KGMTConfig | None = None, system=None,
                 width_rollouts: int = 1024, rows: int = 10):
        self.config = config or KGMTConfig()
        self.system = system or get_system(self.config.system)
        # Probes use their own control ranges (NaivePlanner.cu:31-35).
        self.system = dataclasses.replace(self.system, control_spec=PROBE_CONTROL_SPEC)
        self.width_rollouts = width_rollouts  # 32*32 in the reference
        self.rows = rows

        sys_ = self.system
        W, R = self.width_rollouts, self.rows

        @jax.jit
        def _tree(root, key):
            x0 = jnp.broadcast_to(root[: sys_.state_dim], (W, sys_.state_dim))

            def row(carry_key, _):
                k, sub = jax.random.split(carry_key)
                controls = sys_.control_spec.sample(sub, (W,))
                # no validity checks, like the reference probe kernels
                x1 = rollout_unchecked(sys_, x0, controls, PROBE_NUM_DISC)
                return k, jnp.concatenate([x1, controls], axis=-1)

            _, tree = jax.lax.scan(row, key, None, length=R)
            return tree  # [rows, W, SAMPLE_DIM]

        self._tree = _tree

    def plan(self, scenario: Scenario, seed: int = 0) -> ProbeResult:
        """Reference NaivePlanner::plan just calls generateRandomTree
        (NaivePlanner.cu:18-23)."""
        return self.generate_random_tree(scenario, self.width_rollouts * self.rows,
                                         seed=seed)

    def generate_random_tree(self, scenario: Scenario, num_rollouts: int,
                             seed: int = 0) -> ProbeResult:
        root = jnp.asarray(scenario.init)
        key = jax.random.key(seed)
        # Warmup compile, then timed run (the analog of cudaEvent timing
        # around the kernel, NaivePlanner.cu:104-115).
        tree = jax.block_until_ready(self._tree(root, key))
        t0 = time.perf_counter()
        tree = jax.block_until_ready(self._tree(root, key))
        dt = time.perf_counter() - t0
        n = self.width_rollouts * self.rows
        return ProbeResult(
            samples=np.asarray(tree),
            num_rollouts=n,
            kernel_time_s=dt,
            rollouts_per_sec=n / dt,
        )
