"""Streaming Monte-Carlo sweeps: a fixed pool of arena slots, each slot
REFILLED with a fresh randomized scenario the moment its current one
completes.

The static-batch Monte-Carlo sweep (parallel/monte_carlo.py over the batched
arena) runs its while_loop until the SLOWEST problem of the batch finishes —
with randomized scenarios the depth distribution has a long tail, so most
slots idle (masked-out compute) for the last third of the wall time. This
planner removes the barrier: completion is per slot, and a completed slot is
re-seeded in place from a device-side scenario generator, so every wave of
every iteration carries B live problems until the target count drains.

Two further structural wins over the batched arena for THIS workload:

- **No tree storage at all.** The arena keeps [B, M, 7] trees only so paths
  can be extracted; a Monte-Carlo sweep consumes (cost, solved) statistics.
  The compacted frontier carry (parent states + accumulated costs in
  registers) is the entire search state, so the iteration has no window
  commit, no parent ids, and no extraction scan — and slot capacity no
  longer bounds iteration count (no window layout to exhaust; the per-
  scenario budget is ``num_iterations``, the reference's own knob).
- **Per-scenario results still exist**: each completed slot scatters its
  (cost, iterations) row into a [num_scenarios] output buffer keyed by the
  scenario id it was working on, so solve-rate / cost quantiles are exact,
  not pool aggregates.

Scenario generation runs INSIDE the jitted loop (random AABB field + start/
goal rejected against it over a fixed candidate set — the same construction
as parallel.monte_carlo.random_scenarios, keyed by fold_in(key, scenario_id)
so scenario i is identical regardless of which slot or iteration picks it
up). Search semantics per scenario match the fixed-wave arena: round-robin
parents over the compacted frontier, reference acceptance/guidance/goal
rules (KGMT.cu:394-400, 487-538, 635-638), frontier refresh by stable
argsort + gather (the arena's default permutation arm).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cudasbmp_jax.config import KGMTConfig
from cudasbmp_jax.geometry.aabb import point_in_any_obstacle
from cudasbmp_jax.geometry.grid import RegionGrid
from cudasbmp_jax.parallel.batch_kgmt import (
    _region_local,
    _rollout_wave,
)
from cudasbmp_jax.systems.registry import get_system

Array = jax.Array


class StreamState(NamedTuple):
    """Pool state: B slots, each running one scenario at a time. All leaves
    have a leading slot axis except the global bookkeeping tail."""

    # compacted frontier carry (no tree behind it — see module docstring)
    p_x0: Array  # f32 [B, R, state_dim]
    p_cost: Array  # f32 [B, R]
    n_parents: Array  # i32 [B]
    # the slot's current scenario
    obstacles: Array  # f32 [B, K, 4]
    init: Array  # f32 [B, state_dim]
    goal: Array  # f32 [B, 2]
    scn_id: Array  # i32 [B]; -1 = slot drained (no scenarios left)
    slot_it: Array  # i32 [B] iterations spent on the current scenario
    cost_to_goal: Array  # f32 [B], +inf until solved
    # per-slot region statistics (f32 exact counts, arena convention)
    r1_total: Array  # f32 [B, NR1]
    r1_valid: Array  # f32 [B, NR1]
    r2_valid: Array  # f32 [B, NR1, n*n]
    # global bookkeeping
    next_id: Array  # i32 scalar: next unassigned scenario id
    n_done: Array  # i32 scalar: scenarios completed (written to out_*)
    out_cost: Array  # f32 [num_scenarios]
    out_iters: Array  # i32 [num_scenarios]
    it: Array  # i32 scalar global iteration
    key: Array  # master PRNG key


def _gen_scenarios(cfg: KGMTConfig, grid: RegionGrid, key: Array, ids: Array,
                   num_obstacles: int, pad_to: int, state_dim: int):
    """Fresh scenario per id (vmapped): obstacles [*, pad_to, 4] with
    degenerate padding rows, init [*, state_dim], goal [*, 2], plus the
    init's region one-hots for stats seeding. Construction mirrors
    parallel.monte_carlo.random_scenarios (deterministic per id)."""
    margin = 0.5
    obstacle_max_size = 4.0
    wh = jnp.array([cfg.width, cfg.height])

    def one(sid):
        k = jax.random.fold_in(key, sid)
        k_o, k_i, k_g = jax.random.split(k, 3)
        k_pos, k_size = jax.random.split(k_o)
        lo = jax.random.uniform(k_pos, (num_obstacles, 2), minval=0.0,
                                maxval=wh - margin)
        size = jax.random.uniform(k_size, (num_obstacles, 2), minval=0.5,
                                  maxval=obstacle_max_size)
        hi = jnp.minimum(lo + size, wh)
        obstacles = jnp.concatenate([lo, hi], axis=-1)
        pad = jnp.zeros((pad_to - num_obstacles, 4)).at[:, 0:2].set(1.0)
        obstacles = jnp.concatenate([obstacles, pad], axis=0)

        def pick_free(kk):
            cand = jax.random.uniform(kk, (32, 2), minval=margin,
                                      maxval=wh - margin)
            free = ~point_in_any_obstacle(cand, obstacles)
            return cand[jnp.argmax(free)]

        init = jnp.zeros(state_dim).at[0:2].set(pick_free(k_i))
        goal = pick_free(k_g)
        return obstacles, init, goal

    return jax.vmap(one)(ids)


def _init_region_onehots(cfg: KGMTConfig, grid: RegionGrid, init_xy: Array):
    """Root-cell one-hots for stats seeding (arena_init analog)."""
    nr1, n2 = cfg.num_r1, cfg.n * cfg.n
    r1_0, r2_0 = grid.region_indices(init_xy)
    one = (r1_0 >= 0).astype(jnp.float32)
    oh_r1 = (jax.nn.one_hot(jnp.maximum(r1_0, 0), nr1, dtype=jnp.float32)
             * one[:, None])
    loc0 = jnp.where(r2_0 >= 0, r2_0 - jnp.maximum(r1_0, 0) * n2, 0)
    oh_r2 = (oh_r1[:, :, None]
             * jax.nn.one_hot(loc0, n2, dtype=jnp.float32)[:, None, :]
             * (r2_0 >= 0).astype(jnp.float32)[:, None, None])
    return oh_r1, oh_r2


def _scores(cfg: KGMTConfig, r1_total, r1_valid, r2_valid) -> Array:
    """Exploration-guidance scores (updateR1, KGMT.cu:487-538), the arena's
    batched formula over explicit stat arrays."""
    n2 = cfg.n * cfg.n
    avail = r1_valid > 0
    cov_r = (r2_valid > 0).sum(axis=-1).astype(jnp.float32) / n2
    free_vol = (cfg.epsilon + r1_valid) / (cfg.epsilon + r1_total)
    score = free_vol**4 / ((1.0 + cov_r) * (1.0 + r1_total**2))
    score = jnp.where(avail, score, 0.0)
    total = score.sum(axis=-1, keepdims=True)
    return jnp.where(avail, jnp.where(total > 0, score / total, 1.0), 1.0)


def stream_init(cfg: KGMTConfig, grid: RegionGrid, key: Array, B: int, R: int,
                num_scenarios: int, num_obstacles: int, pad_to: int,
                state_dim: int, id_lo: Array | int = 0) -> StreamState:
    """``id_lo`` offsets this pool's scenario-id range to
    [id_lo, id_lo + num_scenarios): scenario ids are GLOBAL (they key both
    the generator and the per-scenario search RNG), so N pools over
    disjoint ranges reproduce one big pool's results bit-for-bit. May be a
    traced value (shard_map partitions by axis_index)."""
    id_lo = jnp.asarray(id_lo, jnp.int32)
    local0 = jnp.arange(B, dtype=jnp.int32)
    ids0 = id_lo + local0
    obstacles, init, goal = _gen_scenarios(cfg, grid, key, ids0,
                                           num_obstacles, pad_to, state_dim)
    oh_r1, oh_r2 = _init_region_onehots(cfg, grid, init[:, 0:2])
    active = local0 < num_scenarios
    return StreamState(
        p_x0=jnp.broadcast_to(init[:, None, :], (B, R, state_dim)),
        p_cost=jnp.zeros((B, R), jnp.float32),
        n_parents=jnp.ones(B, jnp.int32),
        obstacles=obstacles, init=init, goal=goal,
        scn_id=jnp.where(active, ids0, -1),
        slot_it=jnp.zeros(B, jnp.int32),
        cost_to_goal=jnp.full(B, jnp.inf, jnp.float32),
        r1_total=oh_r1, r1_valid=oh_r1, r2_valid=oh_r2,
        next_id=id_lo + jnp.minimum(jnp.int32(B), jnp.int32(num_scenarios)),
        n_done=jnp.zeros((), jnp.int32),
        out_cost=jnp.full(num_scenarios, jnp.inf, jnp.float32),
        out_iters=jnp.zeros(num_scenarios, jnp.int32),
        it=jnp.zeros((), jnp.int32),
        key=key,
    )


def stream_iteration(cfg: KGMTConfig, system, grid: RegionGrid, R: int,
                     num_scenarios: int, num_obstacles: int, pad_to: int,
                     s: StreamState, id_lo: Array | int = 0) -> StreamState:
    """One pool iteration: expand every live slot one wave; complete slots
    that solved or exhausted their per-scenario budget; refill them with
    fresh scenarios while any remain."""
    B = s.scn_id.shape[0]
    nr1, n2 = cfg.num_r1, cfg.n * cfg.n
    S = s.p_x0.shape[-1]
    id_lo = jnp.asarray(id_lo, jnp.int32)
    live = s.scn_id >= 0
    r1_score = _scores(cfg, s.r1_total, s.r1_valid, s.r2_valid)

    # --- parent pick: round-robin over the compacted carry ----------------
    with jax.named_scope("stream_parents"):
        j = (jnp.arange(R, dtype=jnp.int32)[None, :]
             % jnp.maximum(s.n_parents, 1)[:, None])
        x0 = jnp.take_along_axis(s.p_x0, j[:, :, None], axis=1)
        pcost = jnp.take_along_axis(s.p_cost, j, axis=1)

    # --- expansion (vmapped per-slot obstacle sets) -----------------------
    with jax.named_scope("stream_expand"):
        # Per-SCENARIO RNG (r5): slot b's wave keys derive from
        # (master key, its GLOBAL scenario id, its own slot_it) — NOT the
        # pool's global iteration counter — so a scenario's search stream
        # is independent of pool size, slot placement, and what the other
        # slots are doing. This is what makes id-range partitions across
        # pools/chips reproduce the single-pool sweep bit-for-bit
        # (tests/test_streaming_mc.py::test_partitioned_pools_*).
        k_slot = jax.vmap(
            lambda i, t: jax.random.fold_in(jax.random.fold_in(s.key, i), t)
        )(jnp.maximum(s.scn_id, 0), s.slot_it)
        k_ctrl = jax.vmap(lambda k: jax.random.fold_in(k, 0))(k_slot)
        k_accept = jax.vmap(lambda k: jax.random.fold_in(k, 1))(k_slot)
        x1, controls, valid = _rollout_wave(cfg, system, x0, s.obstacles,
                                            k_ctrl)
        valid = valid & live[:, None]

    # --- region stats + lookups (arena one-hot contractions) --------------
    with jax.named_scope("stream_stats"):
        r1 = grid.r1_index(x1[..., 0], x1[..., 1])
        loc, in_r2 = _region_local(grid, x1[..., 0], x1[..., 1], r1)
        in_r1 = r1 >= 0
        oh1 = (jax.nn.one_hot(jnp.maximum(r1, 0), nr1, dtype=jnp.float32)
               * in_r1[..., None])
        ohl = (jax.nn.one_hot(loc, n2, dtype=jnp.float32)
               * in_r2[..., None])
        touched = (live[:, None] & in_r1).astype(jnp.float32)
        valid_f = (valid & in_r1).astype(jnp.float32)
        rhs = jnp.concatenate(
            [ohl * valid_f[..., None], touched[..., None],
             valid_f[..., None]], axis=-1)
        d = jnp.einsum("brc,brl->bcl", oh1, rhs,
                       preferred_element_type=jnp.float32)
        d2_valid, d1_total, d1_valid = d[..., :n2], d[..., n2], d[..., n2 + 1]
        seen = (s.r2_valid > 0).astype(jnp.float32)
        # precision split (mirrors batch_kgmt): score select stays
        # HIGHEST (f32 payload), the {0,1} seen contraction — 64/65ths of
        # the FLOPs — runs at default precision, bitwise-identical with the
        # f32 accumulator
        score_r = jnp.einsum("brc,bc->br", oh1, r1_score,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
        seen_rows = jnp.einsum("brc,bcl->brl", oh1, seen,
                               preferred_element_type=jnp.float32)
        seen_r = (seen_rows * ohl).sum(-1)
        virgin = ~in_r2 | (seen_r == 0)

    with jax.named_scope("stream_accept"):
        u = jax.vmap(lambda k: jax.random.uniform(k, (R,)))(k_accept)
        accept = valid & ((u <= score_r) | virgin)
        child_cost = pcost + controls[..., -1]

    # --- goal (inGoalRegion, KGMT.cu:635-638) ------------------------------
    with jax.named_scope("stream_goal"):
        d2g = ((x1[..., 0] - s.goal[:, None, 0]) ** 2
               + (x1[..., 1] - s.goal[:, None, 1]) ** 2)
        in_goal = accept & (d2g < cfg.goal_threshold**2)
        goal_costs = jnp.where(in_goal, child_cost, jnp.inf)
        best_cost = goal_costs.min(axis=-1)
        cost_to_goal = jnp.minimum(s.cost_to_goal, best_cost)

    # --- frontier refresh: accepted children, compacted by stable argsort --
    with jax.named_scope("stream_frontier"):
        n_acc = accept.sum(axis=-1, dtype=jnp.int32)
        order = jnp.argsort(jnp.where(accept, 0, 1), axis=-1,
                            stable=True).astype(jnp.int32)
        new_x0 = jnp.take_along_axis(x1, order[:, :, None], axis=1)
        new_cost = jnp.take_along_axis(child_cost, order, axis=1)
        keep = (n_acc > 0) & live  # stall -> retry same frontier
        kb = keep[:, None]
        p_x0 = jnp.where(kb[..., None], new_x0, s.p_x0)
        p_cost = jnp.where(kb, new_cost, s.p_cost)
        n_parents = jnp.where(keep, n_acc, s.n_parents)

    # --- completion + refill ----------------------------------------------
    with jax.named_scope("stream_refill"):
        slot_it = jnp.where(live, s.slot_it + 1, s.slot_it)
        solved = jnp.isfinite(cost_to_goal)
        exhausted = slot_it >= cfg.num_iterations
        completed = live & (solved | exhausted)
        # per-scenario result rows (exact, not pool aggregates), indexed
        # LOCALLY (global id - id_lo)
        dst = jnp.where(completed, s.scn_id - id_lo, num_scenarios)
        out_cost = s.out_cost.at[dst].set(cost_to_goal, mode="drop")
        out_iters = s.out_iters.at[dst].set(slot_it, mode="drop")
        n_done = s.n_done + completed.sum(dtype=jnp.int32)
        # assign fresh GLOBAL ids to completed slots while scenarios remain
        pos = jnp.cumsum(completed.astype(jnp.int32)) - 1
        cand_id = s.next_id + pos
        id_hi = id_lo + num_scenarios
        fresh = completed & (cand_id < id_hi)
        next_id = jnp.minimum(
            s.next_id + completed.sum(dtype=jnp.int32), id_hi)
        scn_id = jnp.where(completed, jnp.where(fresh, cand_id, -1),
                           s.scn_id)
        # generate the refills (deterministic per id; vmapped over slots)
        gen_ids = jnp.where(fresh, cand_id, id_lo)
        g_obs, g_init, g_goal = _gen_scenarios(
            cfg, grid, s.key, gen_ids, num_obstacles, pad_to, S)
        oh_r1, oh_r2 = _init_region_onehots(cfg, grid, g_init[:, 0:2])
        fb = fresh[:, None]
        obstacles = jnp.where(fresh[:, None, None], g_obs, s.obstacles)
        init = jnp.where(fb, g_init, s.init)
        goal = jnp.where(fb, g_goal, s.goal)
        p_x0 = jnp.where(fresh[:, None, None],
                         jnp.broadcast_to(g_init[:, None, :], p_x0.shape),
                         p_x0)
        p_cost = jnp.where(fb, 0.0, p_cost)
        n_parents = jnp.where(fresh, 1, n_parents)
        slot_it = jnp.where(fresh, 0, slot_it)
        cost_to_goal = jnp.where(fresh, jnp.inf, cost_to_goal)
        r1_total = jnp.where(fb, oh_r1, s.r1_total + d1_total)
        r1_valid = jnp.where(fb, oh_r1, s.r1_valid + d1_valid)
        r2_valid = jnp.where(fresh[:, None, None], oh_r2,
                             s.r2_valid + d2_valid)

    return StreamState(
        p_x0=p_x0, p_cost=p_cost, n_parents=n_parents,
        obstacles=obstacles, init=init, goal=goal,
        scn_id=scn_id, slot_it=slot_it, cost_to_goal=cost_to_goal,
        r1_total=r1_total, r1_valid=r1_valid, r2_valid=r2_valid,
        next_id=next_id, n_done=n_done,
        out_cost=out_cost, out_iters=out_iters,
        it=s.it + 1, key=s.key,
    )


def stream_solve(cfg: KGMTConfig, system, grid: RegionGrid, key: Array,
                 B: int, R: int, num_scenarios: int, num_obstacles: int,
                 pad_to: int, id_lo: Array | int = 0) -> StreamState:
    s0 = stream_init(cfg, grid, key, B, R, num_scenarios, num_obstacles,
                     pad_to, system.state_dim, id_lo=id_lo)
    body = lambda s: stream_iteration(cfg, system, grid, R, num_scenarios,
                                      num_obstacles, pad_to, s, id_lo=id_lo)
    # hard cap: every scenario gets at most num_iterations waves; the pool
    # drains in ceil(total/B)*budget iterations even at solve rate 0
    cap = (num_scenarios + B - 1) // B * cfg.num_iterations + cfg.num_iterations
    return jax.lax.while_loop(
        lambda s: (s.n_done < num_scenarios) & (s.it < cap), body, s0)


@dataclasses.dataclass
class StreamingMCSummary:
    num_scenarios: int
    solve_rate: float
    mean_cost_solved: float
    cost_quantiles: dict  # p10/p50/p90 over solved scenarios
    mean_iters: float
    num_budget_exhausted: int
    wall_time_s: float
    solves_per_sec: float
    costs: np.ndarray  # f32 [num_scenarios] (inf = unsolved)
    iters: np.ndarray  # i32 [num_scenarios]


class StreamingMonteCarloPlanner:
    """Host-facing streaming sweep. ``pool`` is the number of resident slots
    (compute width); ``cfg.num_iterations`` is the per-scenario wave budget;
    ``cfg.rollouts_per_iter`` the wave width.

    Deployment model: one pool PER CHIP — slots never communicate, so the
    multi-chip/multi-host form is N independent pools over disjoint
    scenario-id ranges. Both the scenario GENERATOR and the per-scenario
    search RNG are keyed by global scenario id (r5), so any partition
    reproduces the single-pool results bit-for-bit — ``run(id_lo=...)``
    runs one partition by hand, ``run_sharded(mesh=...)`` runs one pool
    per device along a mesh axis via shard_map and concatenates
    (tests/test_streaming_mc.py asserts both equal the single pool).
    ``mesh`` passed to the constructor only pins replicated output
    sharding for multi-host callers that want every process to hold the
    full result arrays; it does not shard the pool."""

    def __init__(self, config: KGMTConfig | None = None, pool: int = 1024,
                 mesh: Mesh | None = None, system=None):
        cfg = self.config = config or KGMTConfig()
        self.pool = pool
        self.mesh = mesh
        self.system = system or get_system(cfg.system)
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N,
                               n=cfg.n)
        self._solves: dict = {}

    def _get_solve(self, num_scenarios: int, num_obstacles: int,
                   pad_to: int):
        key_ = (num_scenarios, num_obstacles, pad_to)
        fn = self._solves.get(key_)
        if fn is None:
            cfg, system, grid = self.config, self.system, self.grid
            B, R = self.pool, cfg.rollouts_per_iter

            def _solve(key, id_lo):
                f = stream_solve(cfg, system, grid, key, B, R,
                                 num_scenarios, num_obstacles, pad_to,
                                 id_lo=id_lo)
                return f.out_cost, f.out_iters, f.it

            if self.mesh is not None:
                rep = NamedSharding(self.mesh, P())
                fn = jax.jit(_solve, out_shardings=(rep, rep, rep))
            else:
                fn = jax.jit(_solve)
            self._solves[key_] = fn
        return fn

    def run(self, num_scenarios: int, seed: int = 0, num_obstacles: int = 8,
            id_lo: int = 0) -> StreamingMCSummary:
        """Sweep scenario ids [id_lo, id_lo + num_scenarios). ``id_lo > 0``
        runs one partition of a larger sweep — results are bitwise the
        corresponding slice of the unpartitioned run (same seed)."""
        cfg = self.config
        if num_obstacles > cfg.max_obstacles:
            raise ValueError(
                f"{num_obstacles} obstacles > max {cfg.max_obstacles}")
        pad_to = min(cfg.max_obstacles, max(8, -(-num_obstacles // 8) * 8))
        fn = self._get_solve(num_scenarios, num_obstacles, pad_to)
        t0 = time.perf_counter()
        costs, iters, _ = jax.block_until_ready(
            fn(jax.random.key(seed), jnp.int32(id_lo)))
        wall = time.perf_counter() - t0
        costs = np.asarray(costs)
        iters = np.asarray(iters)
        solved = np.isfinite(costs)
        q = (np.quantile(costs[solved], [0.1, 0.5, 0.9]).round(3).tolist()
             if solved.any() else [float("nan")] * 3)
        return StreamingMCSummary(
            num_scenarios=num_scenarios,
            solve_rate=float(solved.mean()),
            mean_cost_solved=float(costs[solved].mean()) if solved.any()
            else float("nan"),
            cost_quantiles={"p10": q[0], "p50": q[1], "p90": q[2]},
            mean_iters=float(iters.mean()),
            num_budget_exhausted=int((~solved).sum()),
            wall_time_s=wall,
            solves_per_sec=num_scenarios / wall,
            costs=costs,
            iters=iters,
        )

    def run_sharded(self, num_scenarios: int, mesh: Mesh, seed: int = 0,
                    num_obstacles: int = 8, axis: str = "scenario"
                    ) -> StreamingMCSummary:
        """The multi-chip deployment form: ONE independent pool per device
        along ``axis``, each sweeping a disjoint global-id range
        [k*per, (k+1)*per), with the per-shard result arrays concatenated
        by shard_map's output spec. No collectives anywhere — slots never
        communicate — and the union is bitwise the single-pool sweep (the
        wave RNG is keyed by global scenario id, not pool state)."""
        from cudasbmp_jax.utils.vma import pvary_to

        cfg, system, grid = self.config, self.system, self.grid
        if num_obstacles > cfg.max_obstacles:
            raise ValueError(
                f"{num_obstacles} obstacles > max {cfg.max_obstacles}")
        n_shards = mesh.shape[axis]
        if num_scenarios % n_shards:
            raise ValueError(
                f"num_scenarios={num_scenarios} must divide evenly over "
                f"{n_shards} '{axis}' shards")
        per = num_scenarios // n_shards
        pad_to = min(cfg.max_obstacles, max(8, -(-num_obstacles // 8) * 8))
        B, R = self.pool, cfg.rollouts_per_iter

        # cache the compiled program like _get_solve: a warmup + measured
        # call pair must not pay two full traces/compiles
        cache_key = ("sharded", per, n_shards, axis, num_obstacles, pad_to,
                     id(mesh))
        fn = self._solves.get(cache_key)
        if fn is None:
            def shard_fn(key):
                lo = jax.lax.axis_index(axis).astype(jnp.int32) * per
                s0 = stream_init(cfg, grid, key, B, R, per, num_obstacles,
                                 pad_to, system.state_dim, id_lo=lo)
                # the carry mixes id-derived (varying) and constant
                # (replicated) leaves; promote everything to varying so the
                # while_loop carry has one consistent VMA type under
                # check_vma (kgmt.py pattern)
                s0 = pvary_to(s0, (axis,))
                cap = ((per + B - 1) // B * cfg.num_iterations
                       + cfg.num_iterations)
                f = jax.lax.while_loop(
                    lambda s: (s.n_done < per) & (s.it < cap),
                    lambda s: stream_iteration(cfg, system, grid, R, per,
                                               num_obstacles, pad_to, s,
                                               id_lo=lo),
                    s0)
                return f.out_cost, f.out_iters

            fn = jax.jit(jax.shard_map(
                shard_fn, mesh=mesh, in_specs=P(),
                out_specs=(P(axis), P(axis))))
            self._solves[cache_key] = fn
        # replicate before fetching: under a MULTI-PROCESS mesh the sharded
        # outputs are not fully addressable, and every host wants the whole
        # result table (one small all_gather; free single-process)
        rep_key = ("replicate", id(mesh))
        rep_fn = self._solves.get(rep_key)
        if rep_fn is None:
            rep = NamedSharding(mesh, P())
            rep_fn = jax.jit(lambda c, i: (c, i), out_shardings=(rep, rep))
            self._solves[rep_key] = rep_fn
        t0 = time.perf_counter()
        costs, iters = jax.block_until_ready(
            rep_fn(*fn(jax.random.key(seed))))
        wall = time.perf_counter() - t0
        costs = np.asarray(costs)
        iters = np.asarray(iters)
        solved = np.isfinite(costs)
        q = (np.quantile(costs[solved], [0.1, 0.5, 0.9]).round(3).tolist()
             if solved.any() else [float("nan")] * 3)
        return StreamingMCSummary(
            num_scenarios=num_scenarios,
            solve_rate=float(solved.mean()),
            mean_cost_solved=float(costs[solved].mean()) if solved.any()
            else float("nan"),
            cost_quantiles={"p10": q[0], "p50": q[1], "p90": q[2]},
            mean_iters=float(iters.mean()),
            num_budget_exhausted=int((~solved).sum()),
            wall_time_s=wall,
            solves_per_sec=num_scenarios / wall,
            costs=costs,
            iters=iters,
        )
