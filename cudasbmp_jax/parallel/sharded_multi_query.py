"""Multi-query OVER sharded trees: B planning problems, each solved by ONE
logical tree sharded over the mesh's ``tree`` axis, with the problem batch
laid over the ``scenario`` axis (BASELINE.json config 5 in full: "1000+
scenario Monte-Carlo across N>=2 hosts with cross-host frontier reduction" —
the Monte-Carlo axis AND the per-problem collective tree at once; neither
exists in the single-GPU reference, SURVEY.md §2.3 P7).

Composition, not new machinery: the per-problem solve is the SAME collective
loop the single-problem ShardedTreePlanner runs (kgmt_run_sharded — psum'd
global guidance, frontier-exchange all_gather, psum'd termination), vmapped
over the problems local to each scenario shard inside one shard_map over the
full ('scenario', 'tree') mesh. Correctness of the nesting: every collective
reduces over ``tree`` only (vmap just batches it), and the vmapped
while_loop's effective trip count — any local problem still running — is a
function of psum'd (tree-invariant) flags only, so the ``tree``-axis peers
of each scenario slot provably run the same trip counts and never deadlock.

Mesh layout: ``scenario`` is outermost (parallel/mesh.py), so across hosts
the network carries only the embarrassingly parallel problem axis while the
chatty per-iteration tree collectives stay on the NVLink of one host.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cudasbmp_jax.config import KGMTConfig, SAMPLE_DIM, Scenario
from cudasbmp_jax.geometry.grid import RegionGrid
from cudasbmp_jax.parallel.multi_query import stack_scenarios
from cudasbmp_jax.parallel.sharded_tree import kgmt_run_sharded, stitch_path
from cudasbmp_jax.planners.kgmt import init_state
from cudasbmp_jax.systems.registry import get_system


@dataclasses.dataclass
class ShardedMultiQueryResult:
    solved: np.ndarray  # bool [B]
    costs: np.ndarray  # f32 [B] (inf where unsolved)
    best_shards: np.ndarray  # i32 [B]
    total_tree_sizes: np.ndarray  # i32 [B] summed over shards
    iterations: np.ndarray  # i32 [B]
    paths: list  # B stitched [L_b, SAMPLE_DIM] arrays (root -> goal)
    path_shards: list  # B [L_b] shard-owner arrays
    wall_time_s: float
    solves_per_sec: float


class ShardedMultiQueryPlanner:
    """B problems x one D-shard logical tree each, on a (scenario, tree)
    mesh. B must be divisible by the scenario-axis size."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: Mesh | None = None, system=None):
        if mesh is None or "tree" not in mesh.shape or "scenario" not in mesh.shape:
            raise ValueError("ShardedMultiQueryPlanner requires a "
                             "('scenario', 'tree') mesh "
                             "(parallel.mesh.make_planner_mesh)")
        self.config = config or KGMTConfig()
        self.mesh = mesh
        self.n_tree = mesh.shape["tree"]
        self.n_scenario = mesh.shape["scenario"]
        self.system = system or get_system(self.config.system)
        cfg, sys_ = self.config, self.system
        grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)

        def _solve_one(init, goal, obstacles, key):
            # identical per-problem program to ShardedTreePlanner._shard_body
            # (same collective loop over 'tree'); the problem key is already
            # per-problem (fold_in(seed, b) on the host)
            shard = jax.lax.axis_index("tree")
            s0 = init_state(cfg, grid, init, jax.random.fold_in(key, shard))
            final, _done = kgmt_run_sharded(cfg, sys_, grid, goal, obstacles,
                                            s0, "tree")
            return (final.cost_to_goal, final.tree_size, final.itr,
                    final.goal_node, final.tree_samples, final.tree_parent)

        def _body(inits, goals, obstacles, keys):
            # local problems vmapped; collectives reduce over 'tree' only
            outs = jax.vmap(_solve_one)(inits, goals, obstacles, keys)
            # add the tree axis so out_specs P('scenario','tree') re-stacks
            # per-shard results into global [B, n_tree, ...]
            return jax.tree.map(lambda x: x[:, None], outs)

        self._solve = jax.jit(
            jax.shard_map(
                _body,
                mesh=mesh,
                in_specs=(P("scenario"), P("scenario"), P("scenario"),
                          P("scenario")),
                out_specs=(P("scenario", "tree"),) * 6,
            )
        )

    def plan_batch(self, inits: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, seed: int = 0
                   ) -> ShardedMultiQueryResult:
        """inits/goals: [B, SAMPLE_DIM]; obstacles: [B, K, 4] or [K, 4]
        (shared). Every shard of a problem's tree roots at that problem's
        init (per-shard custom roots: use ShardedTreePlanner per problem)."""
        cfg = self.config
        B = inits.shape[0]
        if B % self.n_scenario != 0:
            raise ValueError(
                f"batch size {B} must be divisible by the scenario-axis "
                f"size {self.n_scenario}")
        if obstacles.ndim == 2:
            obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(seed), jnp.arange(B))
        t0 = time.perf_counter()
        outs = jax.block_until_ready(
            self._solve(jnp.asarray(inits), jnp.asarray(goals),
                        jnp.asarray(obstacles), keys)
        )
        if not outs[0].is_fully_addressable:
            rep = NamedSharding(self.mesh, P())
            outs = jax.jit(lambda *xs: xs,
                           out_shardings=(rep,) * len(outs))(*outs)
        costs, sizes, iters, goal_nodes, trees, parents = (
            np.asarray(o) for o in outs)  # [B, D, ...]
        wall = time.perf_counter() - t0
        best = np.argmin(np.where(np.isfinite(costs), costs, np.inf), axis=1)
        solved = np.isfinite(costs[np.arange(B), best])
        paths, path_shards, best_shards = [], [], np.zeros(B, np.int32)
        for b in range(B):
            if solved[b]:
                gid = int(goal_nodes[b, best[b]])
                p, ps = stitch_path(parents[b], trees[b], gid,
                                    cfg.max_tree_size)
                best_shards[b] = gid // cfg.max_tree_size
            else:
                p = np.zeros((0, SAMPLE_DIM), np.float32)
                ps = np.zeros(0, np.int32)
            paths.append(p)
            path_shards.append(ps)
        return ShardedMultiQueryResult(
            solved=solved,
            costs=costs[np.arange(B), best],
            best_shards=best_shards,
            total_tree_sizes=sizes.sum(axis=1),
            iterations=iters.max(axis=1),
            paths=paths,
            path_shards=path_shards,
            wall_time_s=wall,
            solves_per_sec=B / wall,
        )

    def plan_scenarios(self, scenarios: list[Scenario], seed: int = 0
                       ) -> ShardedMultiQueryResult:
        inits, goals, obstacles = stack_scenarios(self.config, scenarios)
        return self.plan_batch(inits, goals, obstacles, seed=seed)
