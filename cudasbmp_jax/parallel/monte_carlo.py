"""Monte-Carlo planning sweeps: many randomized obstacle scenarios
(BASELINE.json config 5: "1000+ randomized obstacle scenarios across N>=2
hosts"), data-parallel over the mesh with a collective summary reduction.

Scenario generation is deterministic from a key (obstacles, starts and goals
re-sampled until mutually non-colliding, all inside the workspace), so every
process of a multi-host run generates the same global scenario set and takes
its own process-local slice — no scenario broadcast needed (the standard
multi-host input pattern)."""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from cudasbmp_jax.config import KGMTConfig
from cudasbmp_jax.geometry.aabb import point_in_any_obstacle
from cudasbmp_jax.parallel.multi_query import MultiQueryPlanner


def random_scenarios(key, batch: int, config: KGMTConfig,
                     num_obstacles: int = 8, obstacle_max_size: float = 4.0,
                     margin: float = 0.5):
    """Generate ``batch`` random scenarios: (inits, goals, obstacles) arrays
    with shapes [B, 7], [B, 7], [B, K, 4]. Starts/goals avoid obstacles by
    rejection over a fixed candidate set (deterministic, fixed shapes)."""
    cfg = config
    k_obs, k_init, k_goal = jax.random.split(key, 3)

    def one(k_o, k_i, k_g):
        k_pos, k_size = jax.random.split(k_o)
        lo = jax.random.uniform(
            k_pos, (num_obstacles, 2), minval=0.0,
            maxval=jnp.array([cfg.width, cfg.height]) - margin,
        )
        size = jax.random.uniform(k_size, (num_obstacles, 2), minval=0.5,
                                  maxval=obstacle_max_size)
        hi = jnp.minimum(lo + size, jnp.array([cfg.width, cfg.height]))
        obstacles = jnp.concatenate([lo, hi], axis=-1)

        def pick_free(k):
            # 32 candidates; take the first obstacle-free one (fixed shape)
            cand = jax.random.uniform(
                k, (32, 2), minval=margin,
                maxval=jnp.array([cfg.width, cfg.height]) - margin,
            )
            free = ~point_in_any_obstacle(cand, obstacles)
            idx = jnp.argmax(free)  # first True (or 0 if none — degenerate)
            return cand[idx]

        init = jnp.zeros(7).at[0:2].set(pick_free(k_i))
        goal = jnp.zeros(7).at[0:2].set(pick_free(k_g))
        return init, goal, obstacles

    ks = [jax.random.split(k, batch) for k in (k_obs, k_init, k_goal)]
    inits, goals, obstacles = jax.vmap(one)(*ks)
    # tight-pad the obstacle arrays to a multiple of 8 (the collision loop is
    # O(padded rows) — see Scenario.padded_obstacles), capped at the config max
    if num_obstacles > cfg.max_obstacles:
        raise ValueError(f"{num_obstacles} obstacles > max {cfg.max_obstacles}")
    pad_to = min(cfg.max_obstacles, max(8, -(-num_obstacles // 8) * 8))
    pad = pad_to - num_obstacles
    empty = jnp.zeros((batch, pad, 4)).at[:, :, 0:2].set(1.0)  # degenerate
    obstacles = jnp.concatenate([obstacles, empty], axis=1)
    return np.asarray(inits), np.asarray(goals), np.asarray(obstacles)


@dataclasses.dataclass
class MonteCarloSummary:
    num_scenarios: int
    solve_rate: float
    mean_cost_solved: float
    mean_tree_size: float
    wall_time_s: float
    solves_per_sec: float
    costs: np.ndarray
    solved: np.ndarray
    # scenarios that ran out of window/iteration budget unsolved (0 when
    # max_extensions absorbed them all) — surfaced instead of letting
    # capacity exhaustion masquerade as planner failure
    num_budget_exhausted: int = 0


class MonteCarloPlanner:
    """Sweep many random scenarios; multi-host ready (each process feeds its
    local shard; the summary uses global arrays via jax.Array addressable
    data when running single-host, or process-local means otherwise).

    impl='arena' swaps in the scatter-free batched arena
    (parallel/batch_kgmt.py, ~10x throughput at large sweeps; fixed wave
    width; honors cfg.goal_bias via top-k over the compacted frontier) —
    per-scenario obstacle sets take its vmapped kernel path."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: Mesh | None = None, impl: str = "vmap",
                 auto_capacity: bool = False):
        self.config = config or KGMTConfig()
        if impl == "arena":
            from cudasbmp_jax.parallel.batch_kgmt import (
                ArenaMultiQueryPlanner,
            )

            self.planner = ArenaMultiQueryPlanner(
                self.config, mesh=mesh, auto_capacity=auto_capacity)
        else:
            self.planner = MultiQueryPlanner(self.config, mesh=mesh)

    def run(self, num_scenarios: int, seed: int = 0, num_obstacles: int = 8,
            max_extensions: int = 0) -> MonteCarloSummary:
        inits, goals, obstacles = random_scenarios(
            jax.random.key(seed), num_scenarios, self.config,
            num_obstacles=num_obstacles,
        )
        kw = {}
        if max_extensions:
            # progressive-doubling restarts exist only on the arena planner;
            # with impl='vmap' the kwarg would fail deep in plan_batch, so
            # it is rejected up front with a usable message
            from cudasbmp_jax.parallel.batch_kgmt import (
                ArenaMultiQueryPlanner,
            )

            if not isinstance(self.planner, ArenaMultiQueryPlanner):
                raise ValueError(
                    "max_extensions requires impl='arena' (the vmap "
                    "multi-query planner has no restart mechanism)")
            kw = {"max_extensions": max_extensions}
        t0 = time.perf_counter()
        res = self.planner.plan_batch(inits, goals, obstacles, seed=seed + 1,
                                      **kw)
        wall = time.perf_counter() - t0
        solved = res.solved
        exhausted = (int(res.budget_exhausted.sum())
                     if res.budget_exhausted is not None else 0)
        return MonteCarloSummary(
            num_scenarios=num_scenarios,
            solve_rate=float(solved.mean()),
            mean_cost_solved=float(res.costs[solved].mean()) if solved.any()
            else float("nan"),
            mean_tree_size=float(res.tree_sizes.mean()),
            wall_time_s=wall,
            solves_per_sec=num_scenarios / wall,
            costs=res.costs,
            solved=solved,
            num_budget_exhausted=exhausted,
        )
