"""Multi-query planning: a batch of init/goal pairs solved simultaneously,
sharded over the mesh's ``scenario`` axis (BASELINE.json config 4: "256
init/goal pairs planned simultaneously, sharded across one host").

Design: the whole single-problem solve (``kgmt_solve`` — itself a
jitted while_loop) is ``vmap``-ed over the problem batch, then jitted with a
NamedSharding that lays the batch over devices. Each problem runs its own
while_loop trip count; vmap converts the batch of while_loops into one loop
that runs until the LAST problem terminates, with per-problem done-masking —
exactly the dense masked semantics the planner already uses internally, and a
far better fit for SPMD than the reference's host-driven loop (which could
never batch problems at all: one KGMT instance owns one tree,
KGMT.cu:16-77).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.geometry.grid import RegionGrid
from cudasbmp_jax.planners.kgmt import extract_path, kgmt_solve
from cudasbmp_jax.systems.registry import get_system


def stack_scenarios(cfg: KGMTConfig, scenarios: list[Scenario]
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack a scenario list into batched (inits, goals, obstacles) with ONE
    static obstacle shape: tight-pad every scenario to the LARGEST one's
    padded count (padded_obstacles rounds to a multiple of 8). Shared by the
    batched planners (MultiQueryPlanner, ShardedMultiQueryPlanner) so the
    padding policy lives in one place."""
    inits = np.stack([s.init for s in scenarios])
    goals = np.stack([s.goal for s in scenarios])
    pad_to = max(
        s.padded_obstacles(cfg.max_obstacles)[0].shape[0] for s in scenarios
    )
    obstacles = np.stack(
        [s.padded_obstacles(cfg.max_obstacles, pad_to=pad_to)[0]
         for s in scenarios]
    )
    return inits, goals, obstacles


@dataclasses.dataclass
class MultiQueryResult:
    solved: np.ndarray  # bool [B]
    costs: np.ndarray  # f32 [B] (inf where unsolved)
    tree_sizes: np.ndarray  # i32 [B]
    iterations: np.ndarray  # i32 [B]
    paths: np.ndarray  # f32 [B, L, SAMPLE_DIM]
    path_lengths: np.ndarray  # i32 [B]
    wall_time_s: float
    solves_per_sec: float
    # True where the problem is unsolved because it ran out of iteration/
    # window budget. The reference stops
    # silently in the same situation (tree full -> break, KGMT.cu:251-259).
    budget_exhausted: np.ndarray | None = None


class MultiQueryPlanner:
    """Plan B problems at once, batch sharded over the ``scenario`` axis."""

    def __init__(self, config: KGMTConfig | None = None, mesh: Mesh | None = None,
                 system=None):
        self.config = config or KGMTConfig()
        self.mesh = mesh
        self.system = system or get_system(self.config.system)
        cfg = self.config
        grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
        sys_ = self.system

        def _solve_one(init, goal, obstacles, key):
            final = kgmt_solve(cfg, sys_, grid, init, goal, obstacles, key)
            nodes, samples, length = extract_path(cfg, final)
            return (final.cost_to_goal, final.tree_size, final.itr,
                    samples, length)

        batched = jax.vmap(_solve_one)
        if mesh is not None:
            shard = NamedSharding(mesh, P("scenario"))
            self._solve = jax.jit(
                batched,
                in_shardings=(shard, shard, shard, shard),
                out_shardings=(shard, shard, shard, shard, shard),
            )
        else:
            self._solve = jax.jit(batched)

    def plan_batch(self, inits: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, seed: int = 0) -> MultiQueryResult:
        """inits/goals: [B, SAMPLE_DIM]; obstacles: [B, K, 4] or [K, 4]
        (shared). B must be divisible by the scenario-axis size."""
        B = inits.shape[0]
        if self.mesh is not None:
            n_shard = self.mesh.shape["scenario"]
            if B % n_shard != 0:
                raise ValueError(
                    f"batch size {B} must be divisible by the scenario-axis "
                    f"size {n_shard} (pad the batch or change the mesh)"
                )
        if obstacles.ndim == 2:
            obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(seed), jnp.arange(B)
        )
        t0 = time.perf_counter()
        outs = jax.block_until_ready(
            self._solve(jnp.asarray(inits), jnp.asarray(goals),
                        jnp.asarray(obstacles), keys)
        )
        if not outs[0].is_fully_addressable:
            # multi-host: replicate results so every controller returns the
            # full batch (every process passed the same global inputs)
            rep = NamedSharding(self.mesh, P())
            outs = jax.jit(lambda *xs: xs,
                           out_shardings=(rep,) * len(outs))(*outs)
        costs, tree_sizes, iters, samples, lengths = outs
        wall = time.perf_counter() - t0
        costs = np.asarray(costs)
        solved = np.isfinite(costs)
        tree_sizes = np.asarray(tree_sizes)
        iters = np.asarray(iters)
        cfg = self.config
        return MultiQueryResult(
            solved=solved,
            costs=costs,
            tree_sizes=tree_sizes,
            iterations=iters,
            paths=np.asarray(samples),
            path_lengths=np.asarray(lengths),
            wall_time_s=wall,
            solves_per_sec=B / wall,
            budget_exhausted=~solved & ((iters >= cfg.num_iterations)
                                        | (tree_sizes >= cfg.max_tree_size)),
        )

    def plan_scenarios(self, scenarios: list[Scenario], seed: int = 0
                       ) -> MultiQueryResult:
        inits, goals, obstacles = stack_scenarios(self.config, scenarios)
        return self.plan_batch(inits, goals, obstacles, seed=seed)
