"""CostProp chained-rollout probe — the reference's second prototype
(src/planners/CostPropPlanner.cu): 1024x512 = 524,288 bicycle rollouts in one
launch, rows chained so each row's start states come from the previous row's
outputs (CostPropPlanner.cu:75-79), persistent RNG streams, no collision
checking. Used as the raw propagation-throughput benchmark.

Chaining here: rollout lane j in row r starts from the row r-1 output of its
group leader (lane ``j - j % group_size``), matching the reference's
block-shared parent (each CUDA block re-reads its block's first column,
group = 1024-thread block). ``group_size=1`` instead chains every lane through
its own previous output.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.ops.rollout import rollout_unchecked
from cudasbmp_jax.planners.base import Planner
from cudasbmp_jax.planners.naive import PROBE_CONTROL_SPEC, PROBE_NUM_DISC, ProbeResult
from cudasbmp_jax.systems.registry import get_system


class CostPropPlanner(Planner):
    def __init__(self, config: KGMTConfig | None = None, system=None,
                 width_rollouts: int = 1024 * 512, rows: int = 1,
                 group_size: int = 1024):
        self.config = config or KGMTConfig()
        self.system = system or get_system(self.config.system)
        self.system = dataclasses.replace(self.system, control_spec=PROBE_CONTROL_SPEC)
        self.width_rollouts = width_rollouts
        self.rows = rows
        self.group_size = group_size

        sys_ = self.system
        W, R, G = width_rollouts, rows, group_size
        leader = (jnp.arange(W) // G) * G  # group-leader lane per lane

        @jax.jit
        def _tree(root, key):
            x0 = jnp.broadcast_to(root[: sys_.state_dim], (W, sys_.state_dim))

            def row(carry, _):
                x0_row, k = carry
                k, sub = jax.random.split(k)
                controls = sys_.control_spec.sample(sub, (W,))
                # no validity checks, like the reference probe kernels
                x1 = rollout_unchecked(sys_, x0_row, controls, PROBE_NUM_DISC)
                sample = jnp.concatenate([x1, controls], axis=-1)
                next_x0 = x1[leader]  # chain from group leader (see module doc)
                return (next_x0, k), sample

            (_, _), tree = jax.lax.scan(row, (x0, key), None, length=R)
            return tree  # [rows, W, SAMPLE_DIM]

        self._tree = _tree

    def plan(self, scenario: Scenario, seed: int = 0) -> ProbeResult:
        return self.generate_random_tree(scenario, self.width_rollouts * self.rows,
                                         seed=seed)

    def generate_random_tree(self, scenario: Scenario, num_rollouts: int,
                             seed: int = 0) -> ProbeResult:
        root = jnp.asarray(scenario.init)
        key = jax.random.key(seed)
        tree = jax.block_until_ready(self._tree(root, key))  # compile warmup
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
