"""Batched-arena KGMT: many problems in ONE explicitly-batched device program,
with scatter-free per-iteration glue (BASELINE config 4).

Why not vmap(kgmt_solve)? That design (parallel/multi_query.py) is correct
but pays a scatter tax at batch shapes: the per-iteration tree commit and
the region-stats scatter-add dominated multi-query time on the previous
accelerator, far above the rollouts. Both scatters exist only because
per-problem tree offsets DIVERGE under vmap (each problem's while_loop
counter and acceptance counts differ), forcing XLA to lower commits as
gather/scatter.

The arena removes the divergence by construction:

- ONE global iteration counter drives the whole batch, so every problem
  commits its wave at the SAME tree offset — window ``w`` of every problem
  is slots [w*R, (w+1)*R). The commit is a shared-offset
  ``dynamic_update_slice``.
- Region statistics become one-hot CONTRACTIONS: the two-level R2
  histogram is ``einsum(onehot_r1, onehot_local * value)``, and the
  per-rollout score/virgin-cell lookups ride the same one-hots.
- The frontier is carried COMPACTED in registers ([B, R] parent rows,
  costs, ids), refreshed each iteration from the wave's accepted children —
  no tree gather at all. The refresh compaction and the round-robin parent
  pick are stable argsort + take_along_axis; ``one_hot_permute=True``
  applies both as ONE-HOT PERMUTATION MATMULS instead (cumsum ->
  destination slot -> one-hot -> einsum), bitwise identical (see
  _permute_rows).

Search-semantics relation to the flagship (planners/kgmt.py): the arena is
the fixed-wave-width mode (``adaptive_waves=False`` equivalent): every
iteration spawns exactly ``rollouts_per_iter`` rollouts round-robin over the
accepted frontier — the same collapse of the reference's two launch regimes
(KGMT.cu:151-219) the single planner uses, minus the per-node-fan-out
guarantee of adaptive sub-waves. Acceptance, guidance scores, goal test and
cost bookkeeping match the reference semantics exactly (KGMT.cu:394-400,
487-538, 540-593, 635-638). The tree stores every wave's R slots with an
accept mask (rejected slots are dead weight in HBM instead of being
compacted away) — the price of shared offsets; ``max_tree_size`` therefore
bounds ITERATIONS at ``max_tree_size/R - 1``, and effective (valid) tree
capacity is acceptance_rate * max_tree_size.
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

from cudasbmp_jax.config import KGMTConfig, SAMPLE_DIM, Scenario
from cudasbmp_jax.geometry.grid import RegionGrid
from cudasbmp_jax.parallel.multi_query import MultiQueryResult, stack_scenarios
from cudasbmp_jax.systems.registry import get_system

Array = jax.Array

# Row-permutation arms for the per-iteration parent gather + frontier
# compaction. With one_hot_permute both permutations are one-hot matmuls
# (B*R^2*(S+2) multiply-adds), BITWISE identical to the stable argsort +
# take_along_axis form: a permutation one-hot selects exactly one f32 term
# per output (sum of zeros + x = x exactly), and index columns stay below
# 2^24 so their f32 round trip is exact. The one-hot arm paid off on an
# accelerator that serialised gathers; on the H100 argsort + gather won
# every turn at the arena's R=128 (PERF.md), so it is the default. The
# one-hot arm stays for the wider A/B (ROADMAP S4).
def _permute_rows(perm: Array, cols: Array) -> Array:
    """Apply a row permutation as a one-hot contraction: out[b, r] =
    cols[b, perm[b, r]]. perm [B, R] int32 with each row a permutation (or
    any index map) into [0, R); cols [B, R, D] f32. Exact for f32 payloads
    and for integer payloads < 2^24 carried as f32."""
    R = cols.shape[1]
    onehot = (perm[:, :, None]
              == jnp.arange(R, dtype=jnp.int32)[None, None, :])
    # Precision.HIGHEST: a DEFAULT f32 contraction may run in TF32 on the
    # GPU (10 mantissa bits), which would corrupt the payload — tree-slot
    # ids ride here as f32 values far above TF32's exact-integer limit, and
    # states/costs would lose mantissa every iteration. HIGHEST runs in
    # full f32, so the one-hot selection stays bitwise exact.
    return jnp.einsum("bri,bid->brd", onehot.astype(jnp.float32), cols,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


class ArenaState(NamedTuple):
    """Batched planner state; every leaf has a leading problem axis B except
    the GLOBAL iteration counter and PRNG key — their globality is what makes
    all per-iteration offsets batch-uniform (the whole point, see module
    docstring)."""

    tree_samples: Array  # f32 [B, M, SAMPLE_DIM]
    tree_parent: Array  # i32 [B, M], -1 = unset/root
    tree_valid: Array  # bool [B, M]
    costs: Array  # f32 [B, M]
    # compacted frontier carry (this iteration's parents)
    p_x0: Array  # f32 [B, R, state_dim]
    p_cost: Array  # f32 [B, R]
    p_gid: Array  # i32 [B, R] tree slot of each parent
    n_parents: Array  # i32 [B] >= 1
    # region statistics (f32: einsum-accumulated exact integer counts)
    r1_total: Array  # f32 [B, NR1]
    r1_valid: Array  # f32 [B, NR1]
    r2_valid: Array  # f32 [B, NR1, n*n]
    # solution + control
    cost_to_goal: Array  # f32 [B], +inf until solved
    goal_node: Array  # i32 [B], -1 until solved
    solved_at: Array  # i32 [B], iteration of first solution, -1 until then
    done: Array  # bool [B]
    it: Array  # i32 scalar — GLOBAL
    key: Array  # PRNG key — global; per-problem streams derive per use


def _region_local(grid: RegionGrid, x: Array, y: Array,
                  r1: Array) -> tuple[Array, Array]:
    """Local n*n subcell index within an R1 cell (+ in-range mask), matching
    grid.r2_index semantics (KGMT.cu:610-629) without flattening."""
    n = grid.n
    cell_y_r1 = r1 // grid.N
    cell_x_r1 = r1 % grid.N
    local_x = x - cell_x_r1.astype(jnp.float32) * grid.r1_size
    local_y = y - cell_y_r1.astype(jnp.float32) * grid.r1_size
    cx = (local_x / grid.r2_size).astype(jnp.int32)
    cy = (local_y / grid.r2_size).astype(jnp.int32)
    inside = (r1 >= 0) & (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
    return jnp.where(inside, cy * n + cx, 0), inside


def _scores(cfg: KGMTConfig, s: ArenaState) -> Array:
    """Exploration-guidance scores per R1 cell (updateR1, KGMT.cu:487-538) —
    the same formula as planners.kgmt.update_region_scores, batched, with
    invalid = total - valid and avail = (valid > 0) OR the root's init cell
    (folded into r1_valid at init)."""
    n2 = cfg.n * cfg.n
    avail = s.r1_valid > 0
    cov_r = (s.r2_valid > 0).sum(axis=-1).astype(jnp.float32) / n2
    free_vol = (cfg.epsilon + s.r1_valid) / (cfg.epsilon + s.r1_total)
    score = free_vol**4 / ((1.0 + cov_r) * (1.0 + s.r1_total**2))
    score = jnp.where(avail, score, 0.0)
    total = score.sum(axis=-1, keepdims=True)
    return jnp.where(avail, jnp.where(total > 0, score / total, 1.0), 1.0)


def _rollout_wave(cfg: KGMTConfig, system, x0: Array, obstacles: Array,
                  key: Array) -> tuple[Array, Array, Array]:
    """One batched expansion wave: x0 [B, R, S] -> (x1, controls, valid).

    Shared obstacle set ([K, 4]): the batch FLATTENS into one rollout call
    of B*R lanes. Per-problem obstacles ([B, K, 4]): vmap over the batch.

    ``key`` may be a single key (arena: one stream per wave) or a [B] key
    array (streaming MC: per-SLOT streams keyed by scenario id, so id-range
    partitions reproduce bit-for-bit); per-slot keys require per-problem
    obstacles."""
    from cudasbmp_jax.planners.kgmt import _dispatch_rollout

    B, R = x0.shape[0], x0.shape[1]
    per_slot_keys = key.shape == (B,)
    shared_obs = obstacles.ndim == 2
    if per_slot_keys and shared_obs:
        raise ValueError("per-slot keys need per-problem obstacles")
    if per_slot_keys:
        controls = jax.vmap(
            lambda k: system.control_spec.sample(k, (R,)))(key)
    else:
        controls = system.control_spec.sample(key, (B, R))
    if shared_obs:
        x1, valid = _dispatch_rollout(
            cfg, system, x0.reshape(B * R, -1), controls.reshape(B * R, -1),
            obstacles)
        return x1.reshape(B, R, -1), controls, valid.reshape(B, R)
    x1, valid = jax.vmap(
        lambda x, c, ob: _dispatch_rollout(cfg, system, x, c, ob)
    )(x0, controls, obstacles)
    return x1, controls, valid


def arena_init(cfg: KGMTConfig, grid: RegionGrid, inits: Array,
               key: Array, M: int, R: int, state_dim: int) -> ArenaState:
    """Seed every problem's tree with its root (KGMT.cu:85-97 analog):
    slot 0 holds the root; the initial frontier carry is the root repeated
    (n_parents=1 means only entry 0 is ever indexed)."""
    B = inits.shape[0]
    tree_samples = jnp.zeros((B, M, SAMPLE_DIM), jnp.float32)
    tree_samples = tree_samples.at[:, 0, :].set(inits)
    r1_0, r2_0 = grid.region_indices(inits[:, 0:2])
    nr1, n2 = cfg.num_r1, cfg.n * cfg.n
    one = (r1_0 >= 0).astype(jnp.float32)
    oh_r1 = (jax.nn.one_hot(jnp.maximum(r1_0, 0), nr1, dtype=jnp.float32)
             * one[:, None])
    loc0 = jnp.where(r2_0 >= 0, r2_0 - jnp.maximum(r1_0, 0) * n2, 0)
    oh_r2 = (oh_r1[:, :, None]
             * jax.nn.one_hot(loc0, n2, dtype=jnp.float32)[:, None, :]
             * (r2_0 >= 0).astype(jnp.float32)[:, None, None])
    return ArenaState(
        tree_samples=tree_samples,
        tree_parent=jnp.full((B, M), -1, jnp.int32),
        tree_valid=jnp.zeros((B, M), bool).at[:, 0].set(True),
        costs=jnp.zeros((B, M), jnp.float32),
        p_x0=jnp.broadcast_to(inits[:, None, :state_dim],
                              (B, R, state_dim)).astype(jnp.float32),
        p_cost=jnp.zeros((B, R), jnp.float32),
        p_gid=jnp.zeros((B, R), jnp.int32),
        n_parents=jnp.ones(B, jnp.int32),
        r1_total=oh_r1,
        r1_valid=oh_r1,
        r2_valid=oh_r2,
        cost_to_goal=jnp.full(B, jnp.inf, jnp.float32),
        goal_node=jnp.full(B, -1, jnp.int32),
        solved_at=jnp.full(B, -1, jnp.int32),
        done=jnp.zeros(B, bool),
        it=jnp.zeros((), jnp.int32),
        key=key,
    )


def arena_iteration(cfg: KGMTConfig, system, grid: RegionGrid,
                    obstacles: Array, goals: Array, R: int,
                    s: ArenaState, one_hot_permute: bool = False
                    ) -> ArenaState:
    """One global iteration over the whole batch: score -> expand -> stats ->
    accept -> window commit -> goal -> frontier refresh. All offsets are
    batch-uniform; there is no scatter and no per-problem gather from HBM
    trees anywhere in this body."""
    B = s.done.shape[0]
    nr1, n2 = cfg.num_r1, cfg.n * cfg.n
    S = s.p_x0.shape[-1]
    r1_score = _scores(cfg, s)

    # --- parent assignment: round-robin over the compacted frontier carry --
    with jax.named_scope("arena_parents"):
        j = (jnp.arange(R, dtype=jnp.int32)[None, :]
             % jnp.maximum(s.n_parents, 1)[:, None])  # [B, R]
        if cfg.goal_bias > 0.0:
            # top-k goal-nearest parents for the first n_biased slots — the
            # arena analog of kgmt.expansion_wave's goal bias, but over the
            # compacted carry (no tree gather). Assembled by concatenation,
            # keeping the iteration scatter-free.
            with jax.named_scope("arena_goal_bias_topk"):
                valid_p = (jnp.arange(R, dtype=jnp.int32)[None, :]
                           < s.n_parents[:, None])
                d2 = ((s.p_x0[..., 0] - goals[:, None, 0]) ** 2
                      + (s.p_x0[..., 1] - goals[:, None, 1]) ** 2)
                d2 = jnp.where(valid_p, d2, jnp.inf)
                k = min(cfg.goal_bias_k, R)
                neg_best, near = jax.lax.top_k(-d2, k)  # [B, k]
                n_biased = int(round(cfg.goal_bias * R))
                idx = jnp.arange(n_biased, dtype=jnp.int32) % k
                ok = jnp.isfinite(-neg_best)[:, idx]
                biased = jnp.where(ok, near[:, idx].astype(jnp.int32),
                                   j[:, :n_biased])
                j = jnp.concatenate([biased, j[:, n_biased:]], axis=1)
        if one_hot_permute:
            cols = jnp.concatenate(
                [s.p_x0, s.p_cost[:, :, None],
                 s.p_gid.astype(jnp.float32)[:, :, None]], axis=-1)
            picked = _permute_rows(j, cols)
            x0 = picked[..., :S]
            pcost = picked[..., S]
            pgid = picked[..., S + 1].astype(jnp.int32)
        else:
            x0 = jnp.take_along_axis(s.p_x0, j[:, :, None], axis=1)
            pcost = jnp.take_along_axis(s.p_cost, j, axis=1)
            pgid = jnp.take_along_axis(s.p_gid, j, axis=1)

    # --- expansion (one rollout call over B*R lanes) ----------------------
    with jax.named_scope("arena_expand"):
        key_it = jax.random.fold_in(s.key, s.it)
        k_ctrl, k_accept = jax.random.split(key_it)
        x1, controls, valid = _rollout_wave(cfg, system, x0, obstacles,
                                            k_ctrl)
        live = ~s.done
        valid = valid & live[:, None]

    # --- region statistics + lookups as one-hot contractions ---------------
    with jax.named_scope("arena_stats"):
        r1 = grid.r1_index(x1[..., 0], x1[..., 1])  # [B, R]
        loc, in_r2 = _region_local(grid, x1[..., 0], x1[..., 1], r1)
        in_r1 = r1 >= 0
        oh1 = (jax.nn.one_hot(jnp.maximum(r1, 0), nr1, dtype=jnp.float32)
               * in_r1[..., None])  # [B, R, NR1]
        ohl = (jax.nn.one_hot(loc, n2, dtype=jnp.float32)
               * in_r2[..., None])  # [B, R, n2]
        touched = (live[:, None] & in_r1).astype(jnp.float32)
        valid_f = (valid & in_r1).astype(jnp.float32)
        # one [B,R,NR1]^T @ [B,R,n2+2] contraction: R2-valid histogram plus
        # both R1 columns (replaces the reference's six atomicAdd streams,
        # KGMT.cu:392-410, and the vmap design's 22.7 ms scatter-add)
        rhs = jnp.concatenate(
            [ohl * valid_f[..., None], touched[..., None],
             valid_f[..., None]], axis=-1)
        # default precision is fine HERE: both operands are exactly {0, 1}
        # (TF32- and bf16-exact), and accumulation is f32 via
        # preferred_element_type
        d = jnp.einsum("brc,brl->bcl", oh1, rhs,
                       preferred_element_type=jnp.float32)
        d2_valid, d1_total, d1_valid = d[..., :n2], d[..., n2], d[..., n2 + 1]
        # score + virgin-subcell lookups through the SAME one-hots
        # (KGMT.cu:394-400: accept if rand <= R1Score[r1] or R2 cell empty)
        seen = (s.r2_valid > 0).astype(jnp.float32)  # [B, NR1, n2]
        # The lookups split by precision need: the SCORE column is
        # full-mantissa f32 payload, so its one-hot select stays HIGHEST (a
        # TF32 contraction would perturb acceptance probabilities); the SEEN
        # table is {0,1} (TF32-exact) with an f32 accumulator, so default
        # precision is bitwise-identical — and it is 64/65ths of the
        # lookup FLOPs.
        score_r = jnp.einsum("brc,bc->br", oh1, r1_score,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
        seen_rows = jnp.einsum("brc,bcl->brl", oh1, seen,
                               preferred_element_type=jnp.float32)
        seen_r = (seen_rows * ohl).sum(-1)
        virgin = ~in_r2 | (seen_r == 0)

    with jax.named_scope("arena_accept"):
        u = jax.random.uniform(k_accept, (B, R))
        accept = valid & ((u <= score_r) | virgin)

    # --- window commit: shared-offset dynamic_update_slice -----------------
    with jax.named_scope("arena_commit"):
        win_base = (s.it + 1) * R
        samples1 = jnp.concatenate([x1, controls], axis=-1)
        child_cost = pcost + controls[..., -1]  # getCost = duration
        tree_samples = jax.lax.dynamic_update_slice(
            s.tree_samples, samples1, (0, win_base, 0))
        tree_parent = jax.lax.dynamic_update_slice(
            s.tree_parent, jnp.where(accept, pgid, -1), (0, win_base))
        tree_valid = jax.lax.dynamic_update_slice(
            s.tree_valid, accept, (0, win_base))
        costs = jax.lax.dynamic_update_slice(
            s.costs, jnp.where(accept, child_cost, 0.0), (0, win_base))

    # --- goal check (inGoalRegion, KGMT.cu:635-638) -------------------------
    with jax.named_scope("arena_goal"):
        d2g = ((x1[..., 0] - goals[:, None, 0]) ** 2
               + (x1[..., 1] - goals[:, None, 1]) ** 2)
        in_goal = accept & (d2g < cfg.goal_threshold**2)
        goal_costs = jnp.where(in_goal, child_cost, jnp.inf)
        best = jnp.argmin(goal_costs, axis=-1)
        best_cost = jnp.take_along_axis(goal_costs, best[:, None],
                                        axis=1)[:, 0]
        improved = best_cost < s.cost_to_goal
        cost_to_goal = jnp.where(improved, best_cost, s.cost_to_goal)
        goal_node = jnp.where(improved, win_base + best, s.goal_node)
        newly = improved & (s.solved_at < 0)
        solved_at = jnp.where(newly, s.it + 1, s.solved_at)

    # --- frontier refresh: accepted children, compacted by stable argsort --
    with jax.named_scope("arena_frontier"):
        n_acc = accept.sum(axis=-1, dtype=jnp.int32)
        if one_hot_permute:
            # destination slot per wave element: accepted keep arrival order
            # at the front, rejected pile behind — the exact permutation
            # stable argsort(~accept) produces, built from two cumsums and
            # applied as a one-hot contraction over the SOURCE axis
            # (out[b, r] = sum_i onehot[b, i, r] * cols[b, i]); the original
            # index rides along as an f32 column (< R < 2^24, exact)
            dst = jnp.where(
                accept,
                jnp.cumsum(accept, axis=-1, dtype=jnp.int32) - 1,
                n_acc[:, None]
                + jnp.cumsum(~accept, axis=-1, dtype=jnp.int32) - 1)
            onehot = (dst[:, :, None]
                      == jnp.arange(R, dtype=jnp.int32)[None, None, :])
            iota = jnp.broadcast_to(
                jnp.arange(R, dtype=jnp.float32)[None, :, None], (B, R, 1))
            cols = jnp.concatenate(
                [x1, child_cost[:, :, None], iota], axis=-1)
            # HIGHEST for the same reason as _permute_rows: f32 payload
            # columns must survive the contraction bitwise
            out = jnp.einsum("bir,bid->brd", onehot.astype(jnp.float32),
                             cols, preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            new_x0 = out[..., :S]
            new_cost = out[..., S]
            order = out[..., S + 1].astype(jnp.int32)
        else:
            order = jnp.argsort(jnp.where(accept, 0, 1), axis=-1,
                                stable=True).astype(jnp.int32)
            new_x0 = jnp.take_along_axis(x1, order[:, :, None], axis=1)
            new_cost = jnp.take_along_axis(child_cost, order, axis=1)
        new_gid = win_base + order
        # stall -> retry the same frontier with fresh randomness
        # (keep_frontier_on_stall, planners/kgmt.py); done problems also
        # keep their carry so the state stays frozen
        keep = (n_acc > 0) & live
        kb = keep[:, None]
        p_x0 = jnp.where(kb[..., None], new_x0, s.p_x0)
        p_cost = jnp.where(kb, new_cost, s.p_cost)
        p_gid = jnp.where(kb, new_gid, s.p_gid)
        n_parents = jnp.where(keep, n_acc, s.n_parents)

    solved = jnp.isfinite(cost_to_goal)
    done = s.done | (solved if cfg.stop_on_first_solution
                     else jnp.zeros_like(solved))
    if not cfg.keep_frontier_on_stall:
        done = done | (live & (n_acc == 0))

    return ArenaState(
        tree_samples=tree_samples, tree_parent=tree_parent,
        tree_valid=tree_valid, costs=costs,
        p_x0=p_x0, p_cost=p_cost, p_gid=p_gid, n_parents=n_parents,
        r1_total=s.r1_total + d1_total, r1_valid=s.r1_valid + d1_valid,
        r2_valid=s.r2_valid + d2_valid,
        cost_to_goal=cost_to_goal, goal_node=goal_node, solved_at=solved_at,
        done=done, it=s.it + 1, key=s.key,
    )


def arena_solve(cfg: KGMTConfig, system, grid: RegionGrid, inits: Array,
                goals: Array, obstacles: Array, key: Array,
                M: int, R: int, n_windows: int,
                one_hot_permute: bool = False) -> ArenaState:
    s0 = arena_init(cfg, grid, inits, key, M, R, system.state_dim)
    body = partial(arena_iteration, cfg, system, grid, obstacles, goals, R,
                   one_hot_permute=one_hot_permute)
    return jax.lax.while_loop(
        lambda s: (s.it < n_windows) & jnp.any(~s.done), body, s0)


def arena_extract_paths(s: ArenaState, max_len: int
                        ) -> tuple[Array, Array, Array]:
    """Batched goal->root parent walk (planners.kgmt.extract_path, vmapped
    over the arena): returns (nodes [B, L], samples [B, L, SAMPLE_DIM],
    lengths [B]) left-packed root->goal."""

    def one(samples, parent, goal_node):
        def step(node, _):
            nxt = jnp.where(node >= 0, parent[jnp.maximum(node, 0)], -1)
            return nxt, node

        _, rev = jax.lax.scan(step, goal_node, None, length=max_len)
        length = (rev >= 0).sum()
        idx = jnp.arange(max_len)
        src = length - 1 - idx
        nodes = jnp.where(idx < length, rev[jnp.maximum(src, 0)], -1)
        out = jnp.where((nodes >= 0)[:, None],
                        samples[jnp.maximum(nodes, 0)], 0.0)
        return nodes, out, length

    return jax.vmap(one)(s.tree_samples, s.tree_parent, s.goal_node)


class ArenaMultiQueryPlanner:
    """Host-facing batched multi-query planner (drop-in for
    MultiQueryPlanner where fixed-wave semantics suffice; see module
    docstring for the semantics delta). ``mesh`` shards the problem axis
    (BASELINE config 4) — the arena exchanges nothing between problems, so
    sharding is pure data parallelism. ``one_hot_permute`` selects the
    one-hot permutation arm (bitwise equal to the default argsort arm; kept
    for comparing the two)."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: Mesh | None = None, system=None,
                 auto_capacity: bool = False, one_hot_permute: bool = False):
        cfg = self.config = config or KGMTConfig()
        self.mesh = mesh
        self.system = system or get_system(cfg.system)
        self.auto_capacity = auto_capacity
        self.one_hot_permute = one_hot_permute
        grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N,
                          n=cfg.n)
        R = cfg.rollouts_per_iter
        if auto_capacity:
            # capacity follows the ITERATION budget instead of the other way
            # round: exactly num_iterations windows plus the root block.
            # Removes the hand-tuned "max_tree_size = R*(windows+1)" coupling
            # — the config's num_iterations is the same budget knob the
            # reference exposes (demos/main.cu:23).
            M = (cfg.num_iterations + 1) * R
        else:
            # window layout: slot block w holds iteration w's wave (block 0 =
            # root), so capacity bounds iterations
            M = max(cfg.max_tree_size // R, 2) * R
        if one_hot_permute and M >= 1 << 24:
            # tree-slot ids ride the one-hot matmul as f32 values
            raise ValueError(f"one_hot_permute needs max_tree_size < 2^24, "
                             f"got {M}")
        self.n_windows = min(cfg.num_iterations, M // R - 1)
        self._extensions: dict[int, "ArenaMultiQueryPlanner"] = {}
        self.M, self.R = M, R
        sys_ = self.system
        n_win = self.n_windows

        def _solve(inits, goals, obstacles, key):
            final = arena_solve(cfg, sys_, grid, inits, goals, obstacles,
                                key, M, R, n_win, one_hot_permute)
            nodes, samples, lengths = arena_extract_paths(final, n_win + 1)
            iters = jnp.where(final.solved_at >= 0, final.solved_at,
                              final.it)
            tree_sizes = final.tree_valid.sum(axis=-1, dtype=jnp.int32)
            return (final.cost_to_goal, tree_sizes, iters, samples, lengths)

        if self.n_windows < cfg.num_iterations:
            import warnings

            warnings.warn(
                f"arena window layout bounds iterations at max_tree_size/R-1:"
                f" max_tree_size={cfg.max_tree_size} with rollouts_per_iter="
                f"{R} gives {self.n_windows} windows < num_iterations="
                f"{cfg.num_iterations}; raise max_tree_size or lower "
                f"rollouts_per_iter to get the full budget", stacklevel=2)
        if mesh is not None:
            shard = NamedSharding(mesh, P("scenario"))
            rep = NamedSharding(mesh, P())
            # shared [K, 4] obstacle sets are logically replicated — sharding
            # their leading axis over 'scenario' would split the K rows across
            # devices (and fail outright when K % n_devices != 0); only
            # per-problem [B, K, 4] sets ride the batch sharding
            self._solve_shared_obs = jax.jit(
                _solve,
                in_shardings=(shard, shard, rep, rep),
                out_shardings=(shard,) * 5,
            )
            self._solve_per_obs = jax.jit(
                _solve,
                in_shardings=(shard, shard, shard, rep),
                out_shardings=(shard,) * 5,
            )
            self._solve = None
        else:
            self._solve = jax.jit(_solve)

    def plan_batch(self, inits: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, seed: int = 0,
                   max_extensions: int = 0) -> MultiQueryResult:
        """Same contract as MultiQueryPlanner.plan_batch: inits/goals
        [B, SAMPLE_DIM]; obstacles [K, 4] (shared, fastest: one fused-kernel
        call of B*R lanes) or [B, K, 4].

        ``max_extensions`` > 0 enables progressive-doubling restarts:
        problems that exhaust the window budget
        unsolved are re-planned as FRESH searches with a doubled budget
        (fresh RNG stream per round), up to ``max_extensions`` times —
        the standard iterative-deepening answer to "how big should the
        tree be", replacing hand-tuned capacity constants. Exhausted-and-
        still-unsolved problems are flagged in ``budget_exhausted``."""
        B = inits.shape[0]
        if self.mesh is not None:
            n_shard = self.mesh.shape["scenario"]
            if B % n_shard != 0:
                raise ValueError(
                    f"batch size {B} must be divisible by the scenario-axis "
                    f"size {n_shard}")
        key = jax.random.key(seed)
        obstacles = np.asarray(obstacles)
        solve = self._solve
        if solve is None:  # mesh mode: pick shardings by obstacle layout
            solve = (self._solve_shared_obs if obstacles.ndim == 2
                     else self._solve_per_obs)
        t0 = time.perf_counter()
        outs = jax.block_until_ready(
            solve(jnp.asarray(inits), jnp.asarray(goals),
                  jnp.asarray(obstacles), key))
        if not outs[0].is_fully_addressable:
            rep = NamedSharding(self.mesh, P())
            outs = jax.jit(lambda *xs: xs,
                           out_shardings=(rep,) * len(outs))(*outs)
        costs, tree_sizes, iters, samples, lengths = jax.device_get(outs)
        wall = time.perf_counter() - t0
        costs = np.asarray(costs)
        solved = np.isfinite(costs)
        iters = np.asarray(iters)
        res = MultiQueryResult(
            solved=solved,
            costs=costs,
            tree_sizes=np.asarray(tree_sizes),
            iterations=iters,
            paths=np.asarray(samples),
            path_lengths=np.asarray(lengths),
            wall_time_s=wall,
            solves_per_sec=B / wall,
            budget_exhausted=~solved & (iters >= self.n_windows),
        )
        if max_extensions > 0 and res.budget_exhausted.any():
            res = self._extend(res, inits, goals, obstacles, seed,
                               max_extensions)
        return res

    def _extend(self, res: MultiQueryResult, inits, goals, obstacles,
                seed: int, max_extensions: int) -> MultiQueryResult:
        """Progressive-doubling restarts for budget-exhausted problems.
        Each round re-plans ONLY the exhausted subset (padded to a
        power-of-two bucket so recompiles stay bounded) with 2x the window
        budget of the previous round. Sub-planners are cached per budget."""
        windows = self.n_windows
        # device_get returns read-only arrays; the merge mutates in place
        for f in ("costs", "solved", "tree_sizes", "iterations", "paths",
                  "path_lengths", "budget_exhausted"):
            setattr(res, f, np.array(getattr(res, f)))
        for ext in range(max_extensions):
            idx = np.flatnonzero(res.budget_exhausted)
            if idx.size == 0:
                break
            windows *= 2
            sub = self._extensions.get(windows)
            if sub is None:
                cfg2 = dataclasses.replace(self.config,
                                           num_iterations=windows)
                sub = ArenaMultiQueryPlanner(
                    cfg2, mesh=self.mesh, system=self.system,
                    auto_capacity=True,
                    one_hot_permute=self.one_hot_permute)
                self._extensions[windows] = sub
            # pad the subset to a power-of-two bucket (and a MULTIPLE of the
            # mesh's scenario axis — max() alone breaks for
            # non-power-of-two axes like 6, where the recursive plan_batch
            # would reject a bucket not divisible by n_shard) by repeating
            # the first entry
            bucket = 1 << (int(idx.size - 1)).bit_length()
            bucket = max(bucket, 8)
            if self.mesh is not None:
                n_shard = self.mesh.shape["scenario"]
                bucket = -(-bucket // n_shard) * n_shard
            pad_idx = np.concatenate(
                [idx, np.full(bucket - idx.size, idx[0], np.int64)])
            sub_obs = (obstacles if np.asarray(obstacles).ndim == 2
                       else np.asarray(obstacles)[pad_idx])
            sub_res = sub.plan_batch(
                np.asarray(inits)[pad_idx], np.asarray(goals)[pad_idx],
                sub_obs, seed=seed + 104729 * (ext + 1))
            k = idx.size
            # merge: pad the path axis out to the larger budget's length
            L_old, L_new = res.paths.shape[1], sub_res.paths.shape[1]
            if L_new > L_old:
                res.paths = np.pad(
                    res.paths, ((0, 0), (0, L_new - L_old), (0, 0)))
            res.costs[idx] = sub_res.costs[:k]
            res.solved[idx] = sub_res.solved[:k]
            res.tree_sizes[idx] = sub_res.tree_sizes[:k]
            res.iterations[idx] = sub_res.iterations[:k]
            res.paths[idx] = sub_res.paths[:k]
            res.path_lengths[idx] = sub_res.path_lengths[:k]
            res.budget_exhausted[idx] = sub_res.budget_exhausted[:k]
            res.wall_time_s += sub_res.wall_time_s
            res.solves_per_sec = res.solved.shape[0] / res.wall_time_s
        return res

    def plan_scenarios(self, scenarios: list[Scenario], seed: int = 0
                       ) -> MultiQueryResult:
        inits, goals, obstacles = stack_scenarios(self.config, scenarios)
        return self.plan_batch(inits, goals, obstacles, seed=seed)
