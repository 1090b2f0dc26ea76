"""Sharded-tree planning: ONE logical planner spread over the mesh's ``tree``
axis (SURVEY.md §7 'hard part 5', BASELINE.json cross-host frontier reduction).

Design: each shard owns a tree partition of ``max_tree_size`` slots, expanding
with shard-decorrelated RNG (fold_in(key, axis_index)). TWO collectives per
iteration make the shards one logical planner rather than D independent ones
(both in kgmt_iteration, gated on axis_name):

1. **Global guidance**: the R1/R2 region statistics are all-reduced (psum
   over the ``tree`` axis) before scoring, so all shards share one exploration map — a
   shard that saturates a region suppresses every other shard's sampling
   there (the adaptive-guidance semantics of updateR1, KGMT.cu:487-538,
   applied globally).
2. **Frontier exchange**: every shard all_gathers the ``exchange_k``
   goal-nearest nodes of every shard's frontier and reserves
   ``exchange_frac`` of each expansion wave for parents drawn from that
   pool. Children of foreign parents are committed locally with GLOBAL
   parent ids (owning_shard * max_tree_size + slot), so the D shard-local
   trees form one tree whose paths can cross shards — the collective analog
   of the reference's single compacted frontier (KGMT.cu:139-147). A shard
   whose local frontier went sterile (e.g. walled in) keeps expanding
   foreign nodes and stays productive (tested by the forced-sterile-shard
   test in tests/test_parallel.py).

Termination is likewise global: any shard finding the goal, or all shards
filling, stops the collective while_loop via a psum'd done flag carried in
the loop state (collectives in the body, not the cond — the standard
pattern).

The result is the best (min-cost) solution across shards, its path stitched
across shard boundaries on the host by walking global parent ids; total
logical tree capacity is D * max_tree_size.
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
from cudasbmp_jax.io.checkpoint import load_checkpoint, save_checkpoint
from cudasbmp_jax.planners.kgmt import (
    KGMTState,
    init_state,
    kgmt_iteration,
    pvary_tree,
)
from cudasbmp_jax.utils.vma import pvary_like
from cudasbmp_jax.systems.registry import get_system


def kgmt_run_sharded(cfg: KGMTConfig, system, grid: RegionGrid, goal, obstacles,
                     s0: KGMTState, axis_name: str,
                     max_iters: int | None = None
                     ) -> tuple[KGMTState, jax.Array]:
    """Collective while_loop over the sharded iteration; runs inside
    shard_map. Returns (state, done): ``done`` is the psum'd global
    termination flag — solution found anywhere, every shard full, or the
    iteration budget spent. With ``max_iters`` set, this call runs at most
    that many iterations (chunked execution for checkpoint/resume —
    plan_checkpointed) and ``done`` tells the host loop whether to continue.

    VMA discipline (check_vma=True): the state carry is promoted to
    device-varying up front (init_state mixes varying roots with replicated
    zeros); the loop COND reads only device-invariant values — the psum'd
    done flag and a replicated chunk counter — so every shard provably runs
    the same trip count, which the body's collectives require (a varying
    cond would compile but deadlock if trip counts ever diverged)."""
    n_shards = jax.lax.axis_size(axis_name)
    limit = cfg.num_iterations if max_iters is None else max_iters

    def global_done(s: KGMTState):
        full_all = (
            jax.lax.psum((s.tree_size >= cfg.max_tree_size).astype(jnp.int32),
                         axis_name) == n_shards
        )
        # s.itr advances in lockstep; psum-any makes the budget test
        # device-invariant for the cond
        budget_spent = (
            jax.lax.psum((s.itr >= cfg.num_iterations).astype(jnp.int32),
                         axis_name) > 0
        )
        done = full_all | budget_spent
        if cfg.stop_on_first_solution:
            # anytime mode (stop_on_first_solution=False) keeps iterating
            # past the first solution, retaining the cheapest — same
            # semantics as the unsharded kgmt_run
            done = done | (
                jax.lax.psum(jnp.isfinite(s.cost_to_goal).astype(jnp.int32),
                             axis_name) > 0
            )
        return done

    def cond(carry):
        _s, done, it = carry
        return (it < limit) & ~done

    def body(carry):
        s, _, it = carry
        s = kgmt_iteration(cfg, system, grid, obstacles, goal, s,
                           axis_name=axis_name)
        return s, global_done(s), it + 1

    # promote the carry to the union of axes the body output varies over —
    # {axis_name} alone for the single-problem sharded tree, {scenario,
    # axis_name} when the problem batch is itself sharded (sharded_multi_query)
    s0 = pvary_like(s0, s0, goal, obstacles, extra_axes=(axis_name,))
    s, done, _it = jax.lax.while_loop(
        cond, body,
        (s0, global_done(s0), jnp.zeros((), jnp.int32)),
    )
    return s, done


def stitch_path(parents_by_shard: np.ndarray, samples_by_shard: np.ndarray,
                goal_gid: int, max_tree_size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Walk GLOBAL parent ids from the goal node to the root, hopping shards
    as the chain crosses them (the sharded analog of extract_path's local
    walk). Returns (path [L, SAMPLE_DIM] root->goal, shard_of_node [L])."""
    rows, shards = [], []
    g = int(goal_gid)
    guard = parents_by_shard.size + 1
    while g >= 0 and guard > 0:
        d, i = divmod(g, max_tree_size)
        rows.append(samples_by_shard[d, i])
        shards.append(d)
        g = int(parents_by_shard[d, i])
        guard -= 1
    assert guard > 0, "parent-id cycle: corrupt stitched tree"
    return (np.asarray(rows[::-1], np.float32),
            np.asarray(shards[::-1], np.int32))


@dataclasses.dataclass
class ShardedTreeResult:
    solved: bool
    cost: float
    best_shard: int  # shard owning the goal node
    iterations: int
    total_tree_size: int
    wall_time_s: float
    path: np.ndarray  # [L, SAMPLE_DIM] root -> goal, stitched across shards
    path_shards: np.ndarray  # [L] shard owning each path node
    tree_sizes_by_shard: np.ndarray  # [n_shards]
    r1_scores_by_shard: np.ndarray  # [n_shards, N*N] — identical rows iff
    # the psum'd global-guidance loop is intact


class ShardedTreePlanner:
    """One logical KGMT planner sharded over the mesh ``tree`` axis."""

    def __init__(self, config: KGMTConfig | None = None, mesh: Mesh | None = None,
                 system=None):
        if mesh is None:
            raise ValueError("ShardedTreePlanner requires a mesh with a "
                             "'tree' axis (parallel.mesh.make_planner_mesh)")
        self.config = config or KGMTConfig()
        self.mesh = mesh
        self.n_shards = mesh.shape["tree"]
        self.system = system or get_system(self.config.system)
        cfg, sys_ = self.config, self.system
        grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)

        def _init_body(inits, key):
            # per-shard root (inits rows, usually all the same sample) and
            # decorrelated RNG; leading length-1 axis re-assembles into the
            # [n_shards, ...]-stacked global state under out_specs P("tree")
            shard = jax.lax.axis_index("tree")
            s0 = init_state(cfg, grid, inits[shard],
                            jax.random.fold_in(key, shard))
            return jax.tree.map(lambda x: x[None], pvary_tree(s0, "tree"))

        def _shard_body(inits, goal, obstacles, key):
            shard = jax.lax.axis_index("tree")
            s0 = init_state(cfg, grid, inits[shard],
                            jax.random.fold_in(key, shard))
            final, _done = kgmt_run_sharded(cfg, sys_, grid, goal, obstacles,
                                            s0, "tree")
            # Per-shard results; the host reduces. Full tree arrays are
            # returned for cross-shard path stitching (goal_node/parents are
            # GLOBAL ids). r1_score is computed from the psum'd GLOBAL
            # stats, so every shard must hold an identical copy — returned
            # per shard as a testable witness of the collective guidance
            # loop.
            return (final.cost_to_goal[None], final.tree_size[None],
                    final.itr[None], final.goal_node[None],
                    final.tree_samples[None], final.tree_parent[None],
                    final.r1_score[None])

        # check_vma stays ON (default) in all three programs below:
        # replicated->varying carry transitions are annotated with pvary_tree
        # at the loop boundaries (kgmt_run_sharded, kgmt_iteration) instead
        # of disabling the static safety check wholesale.
        self._solve = jax.jit(
            jax.shard_map(
                _shard_body,
                mesh=mesh,
                in_specs=(P(), P(), P(), P()),
                out_specs=(P("tree"),) * 7,
            )
        )
        self._init_fn = jax.jit(
            jax.shard_map(_init_body, mesh=mesh, in_specs=(P(), P()),
                          out_specs=P("tree"))
        )
        self._chunk_fns: dict[int, object] = {}

    def _chunk_fn(self, chunk: int):
        """Jitted program advancing the stacked global state by at most
        ``chunk`` iterations; returns (state, done). Cached per chunk size."""
        if chunk not in self._chunk_fns:
            cfg, sys_ = self.config, self.system
            grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N,
                              n=cfg.n)

            def _chunk_body(state, goal, obstacles):
                s = jax.tree.map(lambda x: x[0], state)  # this shard's slice
                s, done = kgmt_run_sharded(cfg, sys_, grid, goal, obstacles,
                                           s, "tree", max_iters=chunk)
                return jax.tree.map(lambda x: x[None], s), done

            self._chunk_fns[chunk] = jax.jit(
                jax.shard_map(
                    _chunk_body,
                    mesh=self.mesh,
                    in_specs=(P("tree"), P(), P()),
                    # done is device-invariant (psum) -> replicated out_spec
                    out_specs=(P("tree"), P()),
                )
            )
        return self._chunk_fns[chunk]

    def plan(self, scenario: Scenario, seed: int | None = None,
             inits: np.ndarray | None = None) -> ShardedTreeResult:
        """Solve ``scenario``. ``inits`` optionally seeds each shard's root
        with its own sample ([n_shards, SAMPLE_DIM]; default: every shard
        seeds the scenario's init)."""
        cfg = self.config
        obstacles, _ = scenario.padded_obstacles(cfg.max_obstacles)
        if inits is None:
            inits = np.tile(scenario.init, (self.n_shards, 1))
        inits = np.asarray(inits, np.float32)
        if inits.shape != (self.n_shards, SAMPLE_DIM):
            raise ValueError(f"inits must be [{self.n_shards}, {SAMPLE_DIM}]")
        key = jax.random.key(cfg.seed if seed is None else seed)
        t0 = time.perf_counter()
        outs = jax.block_until_ready(
            self._solve(jnp.asarray(inits), jnp.asarray(scenario.goal),
                        jnp.asarray(obstacles), key)
        )
        if not outs[0].is_fully_addressable:
            # multi-host: the per-shard outputs live across processes;
            # replicate them (an all-gather across hosts — the tree arrays are
            # a few MB) so every controller can stitch on the host below
            rep = NamedSharding(self.mesh, P())
            outs = jax.jit(lambda *xs: xs,
                           out_shardings=(rep,) * len(outs))(*outs)
        (costs, sizes, iters, goal_nodes, trees, parents, scores) = (
            np.asarray(o) for o in outs)
        wall = time.perf_counter() - t0
        return self._build_result(costs, sizes, iters, goal_nodes, trees,
                                  parents, scores, wall)

    def _build_result(self, costs, sizes, iters, goal_nodes, trees, parents,
                      scores, wall) -> ShardedTreeResult:
        """Host-side reduction + cross-shard path stitch shared by plan()
        and plan_checkpointed()."""
        cfg = self.config
        best = int(np.argmin(np.where(np.isfinite(costs), costs, np.inf)))
        solved = bool(np.isfinite(costs[best]))
        if solved:
            path, path_shards = stitch_path(
                parents, trees, int(goal_nodes[best]), cfg.max_tree_size
            )
            best_shard = int(goal_nodes[best]) // cfg.max_tree_size
        else:
            path = np.zeros((0, SAMPLE_DIM), np.float32)
            path_shards = np.zeros(0, np.int32)
            best_shard = best
        return ShardedTreeResult(
            solved=solved,
            cost=float(costs[best]) if solved else float("inf"),
            best_shard=best_shard,
            iterations=int(iters.max()),
            total_tree_size=int(sizes.sum()),
            wall_time_s=wall,
            path=path,
            path_shards=path_shards,
            tree_sizes_by_shard=sizes,
            r1_scores_by_shard=scores,
        )

    # -- elastic recovery: chunked solve with periodic global checkpoints ---

    def _fetch_state(self, stacked: KGMTState) -> KGMTState:
        """Device -> host copy of the stacked global state, replicating
        across processes first if the mesh spans several (each process then
        holds the FULL planner state — any process can restart the job)."""
        leaves = jax.tree.leaves(stacked)
        if not leaves[0].is_fully_addressable:
            rep = NamedSharding(self.mesh, P())
            stacked = jax.jit(lambda s: s, out_shardings=rep)(stacked)
        return jax.device_get(stacked)

    def _to_global(self, state: KGMTState) -> KGMTState:
        """Host stacked state -> global device arrays sharded over the
        ``tree`` axis. Every process passes the identical full state and
        make_array_from_callback assembles the global array from each
        process's addressable slices (device_put cannot target
        non-addressable shardings). Typed PRNG keys travel as raw key data
        and are re-wrapped under the target sharding."""
        shard = NamedSharding(self.mesh, P("tree"))

        def put(x):
            if jax.dtypes.issubdtype(jax.numpy.asarray(x).dtype,
                                     jax.dtypes.prng_key):
                data = np.asarray(jax.random.key_data(x))
                g = jax.make_array_from_callback(
                    data.shape, shard, lambda idx: data[idx])
                return jax.jit(jax.random.wrap_key_data,
                               out_shardings=shard)(g)
            arr = np.asarray(x)
            return jax.make_array_from_callback(
                arr.shape, shard, lambda idx: arr[idx])

        return jax.tree.map(put, state)

    def plan_checkpointed(self, scenario: Scenario, ckpt_dir,
                          checkpoint_every: int = 4,
                          seed: int | None = None,
                          inits: np.ndarray | None = None,
                          resume_from=None,
                          chunk_delay_s: float = 0.0) -> ShardedTreeResult:
        """Solve like plan(), but in ``checkpoint_every``-iteration chunks
        with a full-state checkpoint (io/checkpoint.py npz of the stacked
        [n_shards, ...] KGMTState pytree) written after every chunk —
        process 0 writes, every process holds the replicated state. A job
        killed at ANY point (including mid-write: the torn file fails to
        load and the previous one is used) restarts from the newest intact
        checkpoint via ``resume_from`` and finishes bit-identically to an
        uninterrupted run — the multi-host elastic-recovery story of
        SURVEY.md §5 (the single-process analog is KGMT.plan_recorded +
        resume, tests/test_io.py)."""
        from pathlib import Path

        cfg = self.config
        ckpt_dir = Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        obstacles, _ = scenario.padded_obstacles(cfg.max_obstacles)
        goal = jnp.asarray(scenario.goal)
        obstacles = jnp.asarray(obstacles)
        t0 = time.perf_counter()
        if resume_from is not None:
            loaded = load_checkpoint(resume_from)
            n_ck = int(np.asarray(loaded.itr).shape[0])
            if n_ck != self.n_shards:
                # silently resharding would hand each shard a multi-row
                # slice that _chunk_body's x[0] then truncates — corrupt
                raise ValueError(
                    f"checkpoint {resume_from} holds {n_ck} tree shards but "
                    f"this planner's mesh has n_tree={self.n_shards}; "
                    f"resume on a mesh with the same tree-axis size")
            stacked = self._to_global(loaded)
        else:
            if inits is None:
                inits = np.tile(scenario.init, (self.n_shards, 1))
            inits = np.asarray(inits, np.float32)
            if inits.shape != (self.n_shards, SAMPLE_DIM):
                raise ValueError(
                    f"inits must be [{self.n_shards}, {SAMPLE_DIM}]")
            key = jax.random.key(cfg.seed if seed is None else seed)
            stacked = self._init_fn(jnp.asarray(inits), key)
        chunk_fn = self._chunk_fn(checkpoint_every)
        while True:
            stacked, done = chunk_fn(stacked, goal, obstacles)
            host = self._fetch_state(stacked)
            it = int(np.max(host.itr))
            if jax.process_index() == 0:
                save_checkpoint(host, ckpt_dir / f"sharded_checkpoint_{it}.npz")
            if chunk_delay_s:
                # fault-injection test aid: widen the window in which a kill
                # lands mid-solve (tests/test_multihost.py)
                time.sleep(chunk_delay_s)
            if bool(np.asarray(jax.device_get(done))) or it >= cfg.num_iterations:
                break
        wall = time.perf_counter() - t0
        return self._build_result(
            np.asarray(host.cost_to_goal), np.asarray(host.tree_size),
            np.asarray(host.itr), np.asarray(host.goal_node),
            np.asarray(host.tree_samples), np.asarray(host.tree_parent),
            np.asarray(host.r1_score), wall,
        )
