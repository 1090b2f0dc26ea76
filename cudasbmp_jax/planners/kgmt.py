"""KGMT — frontier-parallel kinodynamic tree search with adaptive two-level
region guidance. The flagship planner, re-designed for batched devices.

Behavioral spec source: ``src/planners/KGMT.cu`` (see SURVEY.md §2.2). The
reference drives a host loop that every iteration launches a score-update
kernel, two thrust scans with device->host size reads, a fan-out expansion
kernel with atomics, and a commit kernel, then syncs a termination flag
(KGMT.cu:118-292 — 3 host syncs/iteration). Here the entire iteration is one
pure function ``KGMTState -> KGMTState`` of fixed shapes, and the whole solve
is a single ``lax.while_loop`` under one ``jax.jit``: zero host round-trips
until the final result fetch.

Mapping (reference mechanism -> this file):
- mask -> scan -> compact frontier (KGMT.cu:139-147)   -> eliminated: commits
  are tail-packed, so the frontier is the contiguous range
  [frontier_lo, tree_size) (ops.compaction remains as a standalone library
  op for general masks)
- propagateG / propagateGV2 two launch regimes
  (KGMT.cu:151-219, 341-482)                           -> one dense rollout
  batch of ``rollouts_per_iter`` slots, round-robin parent assignment,
  slots beyond min(fanout*frontier, capacity) masked
- atomicAdd/atomicExch region stats (KGMT.cu:392-410)  -> ONE one-hot
  contraction for both grid levels (exact integer counts in f32; it replaced
  the packed scatter-adds of ops.segments)
- curand per-slot states seeded time(NULL)
  (KGMT.cu:109-111)                                    -> fold_in(key, itr)
- updateR1 score kernel (KGMT.cu:487-538)              -> vectorized formula
- updateG commit + goal check (KGMT.cu:540-593)        -> masked scatter with
  *correct* capacity clamping (the reference can overflow, SURVEY.md §2.4.4)
- d_costToGoal never zeroed / != 0 test (§2.4.1)       -> explicit +inf sentinel
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.config import KGMTConfig, SAMPLE_DIM, Scenario
from cudasbmp_jax.geometry.grid import RegionGrid
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.planners.base import Planner
from cudasbmp_jax.systems.registry import get_system
from cudasbmp_jax.utils.vma import pvary_like, pvary_to

Array = jax.Array


def pvary_tree(tree, axis_name: str):
    """Promote every device-REPLICATED leaf of a pytree to device-VARYING
    over ``axis_name`` (shard_map's static VMA type system; leaves already
    varying pass through — pcast rejects varying->varying). Needed at
    control-flow boundaries in sharded-tree mode: a while_loop carry seeded
    with replicated constants (zeros arrays, +inf sentinels) whose body
    output is varying fails the VMA check otherwise. This annotation is what
    lets the sharded planner run with check_vma=True instead of disabling
    the safety check wholesale."""
    return pvary_to(tree, (axis_name,))


class KGMTState(NamedTuple):
    """Complete device-resident planner state — the analog of the ~25 device
    vectors the reference allocates in its ctor (KGMT.cu:16-77), organized as
    a pytree so snapshot/restore (checkpointing) and vmap (multi-query) are
    free."""

    # Tree (KGMT.cu:25-26, 40, 70)
    tree_samples: Array  # f32 [M, SAMPLE_DIM]
    tree_parent: Array  # i32 [M], -1 = unset; a local index, or a GLOBAL id
    # (owning_shard * M + slot, possibly another shard's tree) when running
    # under a mesh axis with frontier exchange
    costs: Array  # f32 [M], trajectory time from root
    # The reference tracks the frontier as a boolean mask (d_G_) it must
    # scan+compact every iteration (KGMT.cu:139-147). Because commits are
    # packed contiguously at the tree tail and the next frontier is exactly
    # the nodes committed by this wave (KGMT.cu:586), the frontier here is
    # always the RANGE [frontier_lo, tree_size) — no mask, no compaction
    # pass per iteration. frontier_mask()
    # reconstructs the reference's G array for artifacts.
    frontier_lo: Array  # i32 scalar
    tree_size: Array  # i32 scalar
    # Region statistics (KGMT.cu:30-38)
    r1_total: Array  # i32 [N*N]
    r1_valid: Array
    r1_invalid: Array
    r1_avail: Array
    r1_score: Array  # f32 [N*N], init 1.0 (KGMT.cu:72)
    r2_total: Array  # i32 [N*N*n*n]
    r2_valid: Array
    r2_invalid: Array
    r2_avail: Array
    r1_threshold: Array  # f32 scalar — computed-but-unused knob kept for
    # observability parity (KGMT.cu:526; never read by the kernels, §2.4.2)
    # Staging buffer: the most recent expansion wave's rollouts + parents —
    # the analog of d_unexploredSamples_/d_uParentIdx_ (KGMT.cu:16-17,28-29),
    # sized [rollouts_per_iter] rather than [maxTreeSize] because our wave is
    # a fixed dense batch. Dumped as unexploredSamples.csv/uParentIdx.csv.
    u_samples: Array  # f32 [R, SAMPLE_DIM]
    u_parent: Array  # i32 [R]
    # Solution
    cost_to_goal: Array  # f32 scalar, +inf until solved (explicit, §2.4.1)
    goal_node: Array  # i32 scalar, -1 until solved (global id under a mesh)
    # Control
    itr: Array  # i32 scalar
    key: Array  # PRNG key
    stalled: Array  # bool scalar: expansion wave accepted zero children
    # Per-iteration observability (SURVEY.md §5 metrics plan)
    m_frontier_size: Array  # i32 [num_iterations]
    m_valid: Array  # i32 [num_iterations]
    m_accepted: Array  # i32 [num_iterations]
    m_tree_size: Array  # i32 [num_iterations]


@dataclasses.dataclass
class KGMTResult:
    solved: bool
    cost: float
    iterations: int
    tree_size: int
    wall_time_s: float
    path: np.ndarray  # [L, SAMPLE_DIM] root -> goal node samples
    path_nodes: np.ndarray  # [L] tree indices
    state: KGMTState  # final device state (for dumps/analysis)
    metrics: dict


# ---------------------------------------------------------------------------
# Pure planner kernels (everything below is jit-traced)
# ---------------------------------------------------------------------------


def init_state(cfg: KGMTConfig, grid: RegionGrid, init: Array, key: Array) -> KGMTState:
    """Seed the tree with the root sample and mark its regions, exactly as
    KGMT::plan's prologue does (KGMT.cu:85-97)."""
    M = cfg.max_tree_size
    tree_samples = jnp.zeros((M, SAMPLE_DIM), jnp.float32).at[0].set(init)
    r1_0, r2_0 = grid.region_indices(init[0:2][None, :])
    r1_0, r2_0 = r1_0[0], r2_0[0]
    nr1, nr2 = cfg.num_r1, cfg.num_r2
    # A root OUTSIDE the region grid (tall workspace: height > width, both
    # grid axes width-derived) yields r1_0 = -1; writing 0 at a clamped index
    # is a no-op, avoiding JAX negative-index wrap to the LAST cell.
    one = (r1_0 >= 0).astype(jnp.int32)
    one_r2 = (r2_0 >= 0).astype(jnp.int32)
    r1_0 = jnp.maximum(r1_0, 0)
    r2_0 = jnp.maximum(r2_0, 0)
    zeros_r1 = jnp.zeros(nr1, jnp.int32)
    zeros_r2 = jnp.zeros(nr2, jnp.int32)
    # Metrics arrays must be non-empty even for a zero-iteration budget: the
    # while_loop body is traced regardless of whether it ever runs.
    it = max(cfg.num_iterations, 1)
    return KGMTState(
        tree_samples=tree_samples,
        tree_parent=jnp.full(M, -1, jnp.int32),
        costs=jnp.zeros(M, jnp.float32),
        frontier_lo=jnp.zeros((), jnp.int32),
        tree_size=jnp.ones((), jnp.int32),
        r1_total=zeros_r1.at[r1_0].set(one),
        r1_valid=zeros_r1.at[r1_0].set(one),
        r1_invalid=zeros_r1,
        r1_avail=zeros_r1.at[r1_0].set(one),
        r1_score=jnp.ones(nr1, jnp.float32),
        r2_total=zeros_r2,
        r2_valid=zeros_r2,
        r2_invalid=zeros_r2,
        r2_avail=zeros_r2.at[r2_0].set(one_r2),
        r1_threshold=jnp.zeros((), jnp.float32),
        u_samples=jnp.zeros((cfg.rollouts_per_iter, SAMPLE_DIM), jnp.float32),
        u_parent=jnp.full(cfg.rollouts_per_iter, -1, jnp.int32),
        cost_to_goal=jnp.array(jnp.inf, jnp.float32),
        goal_node=jnp.full((), -1, jnp.int32),
        itr=jnp.zeros((), jnp.int32),
        key=key,
        stalled=jnp.zeros((), bool),
        m_frontier_size=jnp.zeros(it, jnp.int32),
        m_valid=jnp.zeros(it, jnp.int32),
        m_accepted=jnp.zeros(it, jnp.int32),
        m_tree_size=jnp.zeros(it, jnp.int32),
    )


def _dispatch_rollout(cfg: KGMTConfig, system, x0: Array, controls: Array,
                      obstacles: Array, interpret: bool = False
                      ) -> tuple[Array, Array]:
    """Run one batch of rollouts with the implementation
    ``cfg.rollout_backend`` selects: the fused Pallas kernel
    (ops/rollout_pallas.py) or the XLA-compiled jnp path (ops/rollout.py).
    Both keep the reference's break semantics.

    'auto' takes the kernel on a GPU for systems with the SoA hooks and the
    jnp path everywhere else. 'pallas' demands the kernel, so it raises off
    a GPU unless ``interpret`` asks for the Pallas interpreter (tests only).
    ``fast_math`` exists only in the kernel and raises where the jnp path
    runs."""
    from cudasbmp_jax.ops.rollout_pallas import rollout_pallas, supports_system

    on_gpu = jax.default_backend() == "gpu"
    if cfg.rollout_backend == "pallas":
        if not (on_gpu or interpret):
            raise ValueError(
                "rollout_backend='pallas' compiles a Triton kernel, which "
                f"needs a GPU; the default backend is {jax.default_backend()!r}")
        if not supports_system(system):
            raise ValueError(f"system {system.name!r} has no SoA hooks for "
                             "the fused rollout kernel")
        use_kernel = True
    else:
        use_kernel = (cfg.rollout_backend == "auto" and on_gpu
                      and supports_system(system))
    if use_kernel:
        return rollout_pallas(
            system, x0, controls, obstacles,
            num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
            interpret=interpret, footprint=cfg.footprint,
            fast_math=cfg.fast_math,
        )
    if cfg.fast_math:
        raise ValueError("fast_math exists only in the fused kernel, which "
                         "does not run here (rollout_backend="
                         f"{cfg.rollout_backend!r}, backend "
                         f"{jax.default_backend()!r})")
    return rollout_batch(
        system, x0, controls, cfg.num_disc, obstacles, cfg.width, cfg.height,
        footprint=cfg.footprint,
    )


def _expand_rollout(cfg: KGMTConfig, system, key: Array, x0: Array,
                    obstacles: Array) -> tuple[Array, Array, Array]:
    """Sample one control per rollout slot and propagate: the planner analog
    of propagateG's per-thread curand draw + propagateAndCheck call
    (KGMT.cu:386-389). Returns (x1, controls, valid)."""
    controls = system.control_spec.sample(key, (x0.shape[0],))
    x1, valid = _dispatch_rollout(cfg, system, x0, controls, obstacles)
    return x1, controls, valid


def frontier_mask(state: KGMTState, max_tree_size: int) -> Array:
    """Reconstruct the reference's boolean frontier array (d_G_) from the
    contiguous-range representation — for artifacts and analysis."""
    idx = jnp.arange(max_tree_size)
    return (idx >= state.frontier_lo) & (idx < state.tree_size)


def update_region_scores(
    cfg: KGMTConfig, s: KGMTState
) -> tuple[Array, Array]:
    """Phase (a): exploration-guidance scores per R1 cell (updateR1,
    KGMT.cu:487-538).

    score = freeVol^4 / ((1+covR) * (1+count^2)) for explored (avail) cells,
    with freeVol = (eps+valid)/(eps+valid+invalid) and covR the fraction of
    the cell's R2 subcells already reached. Normalized by the total; cells
    never touched score 1.0 so virgin regions always accept.
    """
    n2 = cfg.n * cfg.n
    avail = s.r1_avail != 0
    cov_r = s.r2_avail.reshape(cfg.num_r1, n2).sum(axis=1).astype(jnp.float32) / n2
    valid_f = s.r1_valid.astype(jnp.float32)
    invalid_f = s.r1_invalid.astype(jnp.float32)
    free_vol = (cfg.epsilon + valid_f) / (cfg.epsilon + valid_f + invalid_f)
    count_f = s.r1_total.astype(jnp.float32)
    score = free_vol**4 / ((1.0 + cov_r) * (1.0 + count_f**2))
    score = jnp.where(avail, score, 0.0)
    total = score.sum()
    active = jnp.maximum(avail.sum(), 1)
    # Computed-but-unused in the reference's kernels (§2.4.2); we keep it as an
    # observability signal (mean score over active cells).
    r1_threshold = total / active.astype(jnp.float32)
    r1_score = jnp.where(
        avail, jnp.where(total > 0, score / total, 1.0), 1.0
    )
    return r1_score, r1_threshold


def expansion_wave(cfg: KGMTConfig, system, obstacles: Array, goal: Array,
                   s: KGMTState, wave: Array | int = 0,
                   frontier_lo: Array | None = None,
                   frontier_size: Array | None = None,
                   n_target: Array | None = None,
                   pool: tuple[Array, Array, Array] | None = None,
                   gid_base: Array | int = 0):
    """Compute sub-wave ``wave`` of iteration ``s.itr``'s expansion from the
    current state: the analog of the reference's staging buffer fill
    (d_unexploredSamples_/d_uParentIdx_, propagateG, KGMT.cu:386-389).

    The reference gives EVERY frontier node ``fanout`` children in one launch
    whose width grows with the frontier (KGMT.cu:151-158). Our batch is a
    fixed ``rollouts_per_iter`` slots, so a wide frontier is covered by
    several sub-waves per iteration (kgmt_iteration drives the loop); slot
    ``wave*R + i`` maps round-robin onto the frontier range, and slots at or
    beyond ``n_target`` rollouts are masked. Defaults reproduce a standalone
    single wave over the state's own frontier.

    With ``pool`` set (sharded-tree frontier exchange: (rows [P, SAMPLE_DIM],
    global ids [P] with -1 padding, costs [P]) gathered from every shard),
    the LAST round(exchange_frac*R) slots of each wave draw their parents
    round-robin from the pool's valid entries instead of the local frontier,
    so a shard can expand nodes it does not own. ``gid_base`` is this shard's
    global-id offset (shard*max_tree_size); parent references are returned as
    global ids (== local indices when gid_base is 0).

    Deterministic in (s, wave) via counter-based RNG. Returns (slot_active,
    parent_gid, parent_cost, x1, controls, valid, samples1, k_accept)."""
    M = cfg.max_tree_size
    R = cfg.rollouts_per_iter
    if frontier_lo is None:
        frontier_lo = s.frontier_lo
    if frontier_size is None:
        frontier_size = s.tree_size - s.frontier_lo
    if n_target is None:
        # single-wave default: the reference's two regimes — fan-out per node
        # or fill-remaining-capacity (propagateGV2) — collapse into one dense
        # batch of at most R live slots.
        n_target = jnp.minimum(
            jnp.minimum(cfg.fanout * frontier_size, M - s.tree_size), R
        )
    slot = jnp.arange(R, dtype=jnp.int32)
    gslot = wave * R + slot  # global wave-slot index across sub-waves
    slot_active = gslot < n_target
    parent_idx = frontier_lo + gslot % jnp.maximum(frontier_size, 1)
    if cfg.goal_bias > 0.0:
        # Nearest-neighbor parent selection as a device-side top-k reduction
        # over the tree (beyond-reference; see KGMTConfig.goal_bias): the
        # first n_biased slots cycle over the goal_bias_k frontier nodes
        # nearest the goal, the rest keep the uniform assignment above.
        with jax.named_scope("kgmt_goal_bias_topk"):
            idx = jnp.arange(M)
            in_frontier = (idx >= frontier_lo) & (idx < frontier_lo + frontier_size)
            d2 = ((s.tree_samples[:, 0] - goal[0]) ** 2
                  + (s.tree_samples[:, 1] - goal[1]) ** 2)
            d2 = jnp.where(in_frontier, d2, jnp.inf)
            k = min(cfg.goal_bias_k, M)
            neg_best, near = jax.lax.top_k(-d2, k)
            n_biased = int(round(cfg.goal_bias * R))
            biased = near[jnp.arange(n_biased) % k].astype(jnp.int32)
            # slots whose top-k entry is padding (frontier smaller than k)
            # fall back to their round-robin parent
            ok = jnp.isfinite(-neg_best)[jnp.arange(n_biased) % k]
            parent_idx = parent_idx.at[:n_biased].set(
                jnp.where(ok, biased, parent_idx[:n_biased])
            )
    # Gather parent rows WHOLE, then slice: ts[idx, :4] can lower as four
    # per-column gathers plus a layout copy of the tree, while a full-row
    # gather is one gather of contiguous rows.
    parent_rows = s.tree_samples[parent_idx]
    parent_cost = s.costs[parent_idx]
    parent_gid = gid_base + parent_idx
    if pool is not None:
        pool_rows, pool_ids, pool_costs = pool
        P = pool_ids.shape[0]
        n_pool = int(round(cfg.exchange_frac * R))
        j = gslot % P
        use_pool = (slot >= R - n_pool) & (pool_ids[j] >= 0)  # -1 = padding
        parent_rows = jnp.where(use_pool[:, None], pool_rows[j], parent_rows)
        parent_cost = jnp.where(use_pool, pool_costs[j], parent_cost)
        parent_gid = jnp.where(use_pool, pool_ids[j], parent_gid)
        # Pool slots are active INDEPENDENTLY of the local fan-out target:
        # n_target scales with the LOCAL frontier, so a shard whose own
        # frontier is tiny (or sterile) would otherwise mask off exactly the
        # slots that let it expand foreign nodes.
        slot_active = slot_active | use_pool
    x0 = parent_rows[:, : system.state_dim]

    key_iter = jax.random.fold_in(s.key, s.itr)
    # sub-wave 0 uses the iteration key DIRECTLY (not fold_in(key, 0)) so
    # single-wave iterations — the non-adaptive mode and every iteration
    # whose frontier fits one wave — keep the exact RNG stream of runs and
    # checkpoints from before adaptive waves existed.
    key_wave = jax.lax.cond(
        jnp.asarray(wave) == 0,
        lambda: key_iter,
        lambda: jax.random.fold_in(key_iter, wave),
    )
    k_ctrl, k_accept = jax.random.split(key_wave)
    x1, controls, valid = _expand_rollout(cfg, system, k_ctrl, x0, obstacles)
    valid = valid & slot_active
    samples1 = jnp.concatenate([x1, controls], axis=-1)  # [R, SAMPLE_DIM]
    return (slot_active, parent_gid, parent_cost, x1, controls, valid,
            samples1, k_accept)




def _region_stats_and_accept(cfg: KGMTConfig, grid: RegionGrid, x1: Array,
                             slot_active: Array, valid: Array,
                             r1_score: Array, r2_seen: Array,
                             k_accept: Array):
    """Region-statistic contraction + acceptance rule for one R-slot wave —
    shared by the tree-mode ``_wave_step`` and the pathless (need_path=False)
    driver so the two modes stay bitwise-identical by construction.
    Returns (d1 [NR1, 2], d2 [NR2, 2], accept [R], r2_seen')."""
    R = x1.shape[0]

    # --- region statistics (atomics -> one-hot contraction) -----------
    with jax.named_scope("kgmt_region_stats"):
        r1, r2 = grid.region_indices(x1[:, 0:2])
        # The reference's six atomicAdd streams + two atomicExch flips
        # (KGMT.cu:392-410) first became one packed 2-column scatter per
        # grid level (ops.segments.masked_multi_bincount), then — because
        # the previous accelerator serialised data-dependent scatters —
        # ONE [R, NR1] x [R, 2*n^2+2] contraction for both levels, using
        # r2 = r1*n^2 + loc (grid.r2_index). Counts stay exact: each is
        # a sum of {0,1} terms <= R < 2^24 in f32, cast back to int32.
        # invalid = touched - valid, and a cell becomes available
        # exactly when its valid count first exceeds zero
        # (KGMT.cu:401-406).
        n2 = cfg.n * cfg.n
        in_r1 = r1 >= 0
        in_r2 = r2 >= 0
        loc = jnp.where(in_r2, r2 - r1 * n2, 0)
        oh1 = (jax.nn.one_hot(jnp.maximum(r1, 0), cfg.num_r1,
                              dtype=jnp.float32)
               * in_r1[:, None].astype(jnp.float32))  # [R, NR1]
        ohl = (jax.nn.one_hot(loc, n2, dtype=jnp.float32)
               * in_r2[:, None].astype(jnp.float32))  # [R, n^2]
        act_f = slot_active.astype(jnp.float32)
        val_f = valid.astype(jnp.float32)
        rhs = jnp.concatenate(
            [ohl * act_f[:, None], ohl * val_f[:, None],
             act_f[:, None], val_f[:, None]], axis=-1)
        dmat = jnp.einsum("rc,rl->cl", oh1, rhs,
                          preferred_element_type=jnp.float32)
        d1 = jnp.stack(
            [dmat[:, 2 * n2], dmat[:, 2 * n2 + 1]], axis=-1
        ).astype(jnp.int32)
        d2 = jnp.stack(
            [dmat[:, :n2].ravel(), dmat[:, n2:2 * n2].ravel()], axis=-1
        ).astype(jnp.int32)

    # --- acceptance (KGMT.cu:394-400): Bernoulli(score of child's R1
    #     cell) OR the child's R2 subcell was never reached before -------
    with jax.named_scope("kgmt_accept"):
        u = jax.random.uniform(k_accept, (R,))
        # Score/seen lookups ride the SAME one-hots as the stats pass
        # instead of [R]-from-table gathers, and stay bitwise exact: a
        # one-hot matmul selects one f32 term, the rest are exact +0.0.
        # Valid children OUTSIDE the region grid (possible when height >
        # width: both axes use width-derived cells, KGMT.cu:13-14) are
        # always accepted via the virgin term below — r1 < 0 implies
        # r2 < 0 (grid.py r2_index), and their one-hot rows are all
        # zero, so score_r = 0 never wins the Bernoulli draw. The
        # reference would index its arrays at -1 here (UB, SURVEY.md
        # §2.4.7). r2_seen is the iteration-start snapshot (global in
        # sharded mode) plus earlier sub-waves' arrivals — a
        # deterministic stand-in for the reference's racy read of
        # concurrently-updated flags.
        # Precision.HIGHEST: on the GPU a DEFAULT f32 contraction may run
        # in TF32 (10 mantissa bits), which would perturb the looked-up
        # scores and break the bitwise-exactness claim; HIGHEST runs in
        # full f32. seen_rows stays on DEFAULT precision: both its
        # operands are {0, 1}, exact in TF32 and bf16, and the
        # accumulator is f32 — bitwise-equal to HIGHEST.
        score_r = jnp.matmul(
            oh1, r1_score,
            precision=jax.lax.Precision.HIGHEST)  # [R]; 0.0 where r1 < 0
        seen_rows = jnp.matmul(
            oh1, r2_seen.reshape(cfg.num_r1, n2).astype(jnp.float32),
            preferred_element_type=jnp.float32)
        seen_r = (seen_rows * ohl).sum(axis=-1)
        virgin_r2 = (r2 < 0) | (seen_r == 0)
        accept = valid & ((u <= score_r) | virgin_r2)
    r2_seen = r2_seen | (d2[:, 1] > 0).astype(jnp.int32)
    return d1, d2, accept, r2_seen


def _wave_step(cfg: KGMTConfig, system, grid: RegionGrid, obstacles: Array,
               goal: Array, frontier_lo0, tree_size0, n_target,
               r1_score: Array, gid_base, pool, carry):
    """Phases (c) expand, (d) commit, (e) goal — one R-slot sub-wave of one
    iteration, as a pure ``(w, state, r2_seen) -> (w+1, state, r2_seen)``
    step over the iteration-start context (frontier range, rollout target,
    scores, exchange pool). NO collectives in here: in sharded mode the
    trip count differs per shard (frontier widths differ), so anything
    collective would deadlock; region stats are psum'd once per iteration
    in kgmt_iteration phase (a).

    Shared by BOTH drivers: kgmt_iteration's nested wave while_loop (the
    sharded/recorded path) and kgmt_run's flat (iteration x wave) loop (the
    unsharded fast path — see kgmt_run for why flat wins)."""
    M = cfg.max_tree_size
    R = cfg.rollouts_per_iter
    frontier_size = tree_size0 - frontier_lo0
    w, s_in, r2_seen = carry

    with jax.named_scope("kgmt_expand"):
        (slot_active, parent_gid, parent_cost, x1, controls, valid,
         samples1, k_accept) = expansion_wave(
            cfg, system, obstacles, goal, s_in, wave=w,
            frontier_lo=frontier_lo0, frontier_size=frontier_size,
            n_target=n_target, pool=pool, gid_base=gid_base)

    d1, d2, accept, r2_seen = _region_stats_and_accept(
        cfg, grid, x1, slot_active, valid, r1_score, r2_seen, k_accept)

    # --- commit (updateG, KGMT.cu:540-593), correct capacity clamp ----
    with jax.named_scope("kgmt_commit"):
        accept_i = accept.astype(jnp.int32)
        accept_pos = jnp.cumsum(accept_i) - accept_i
        child_slot = s_in.tree_size + accept_pos
        within = accept & (child_slot < M)
        n_accepted = jnp.minimum(accept_i.sum(), M - s_in.tree_size)
        dst = jnp.where(within, child_slot, M)  # OOB -> dropped
        tree_samples = s_in.tree_samples.at[dst].set(samples1, mode="drop")
        # parent references are global ids under a mesh axis (gid_base
        # offset; may point into ANOTHER shard's tree via the exchange
        # pool), plain local indices otherwise
        tree_parent = s_in.tree_parent.at[dst].set(parent_gid, mode="drop")
        # cost = parent cost + edge duration (getCost returns x1[6],
        # KGMT.cu:631-633: the metric is pure trajectory time).
        child_cost = parent_cost + controls[:, -1]
        costs = s_in.costs.at[dst].set(child_cost, mode="drop")

    # --- goal check (inGoalRegion, KGMT.cu:635-638) --------------------
    with jax.named_scope("kgmt_goal"):
        d2g = (x1[:, 0] - goal[0]) ** 2 + (x1[:, 1] - goal[1]) ** 2
        in_goal = within & (d2g < cfg.goal_threshold**2)
        goal_costs = jnp.where(in_goal, child_cost, jnp.inf)
        best = jnp.argmin(goal_costs)
        best_cost = goal_costs[best]
        improved = best_cost < s_in.cost_to_goal
        cost_to_goal = jnp.where(improved, best_cost, s_in.cost_to_goal)
        # goal_node is a global id under a mesh axis (gid_base = 0 else)
        goal_node = jnp.where(improved, gid_base + child_slot[best],
                              s_in.goal_node)

    s_out = s_in._replace(
        tree_samples=tree_samples,
        tree_parent=tree_parent,
        costs=costs,
        tree_size=s_in.tree_size + n_accepted,
        r1_total=s_in.r1_total + d1[:, 0],
        r1_valid=s_in.r1_valid + d1[:, 1],
        r1_invalid=s_in.r1_invalid + (d1[:, 0] - d1[:, 1]),
        r1_avail=s_in.r1_avail | (d1[:, 1] > 0).astype(jnp.int32),
        r2_total=s_in.r2_total + d2[:, 0],
        r2_valid=s_in.r2_valid + d2[:, 1],
        r2_invalid=s_in.r2_invalid + (d2[:, 0] - d2[:, 1]),
        r2_avail=s_in.r2_avail | (d2[:, 1] > 0).astype(jnp.int32),
        u_samples=samples1,  # staging buffer holds the latest sub-wave
        u_parent=parent_gid,
        cost_to_goal=cost_to_goal,
        goal_node=goal_node,
        m_valid=s_in.m_valid.at[s_in.itr].add(valid.sum()),
        m_accepted=s_in.m_accepted.at[s_in.itr].add(n_accepted),
    )
    return w + 1, s_out, r2_seen


def kgmt_iteration(cfg: KGMTConfig, system, grid: RegionGrid, obstacles: Array,
                   goal: Array, s: KGMTState, axis_name: str | None = None
                   ) -> KGMTState:
    """One full planner iteration: phases (a) score, (b) compact, (c) expand,
    (d) commit, (e) goal/termination bookkeeping — the body of the reference's
    host loop (KGMT.cu:118-292) as one fused device program.

    With ``axis_name`` set (sharded-tree mode, SURVEY.md P7), two collectives
    make the shards ONE logical planner: (1) region statistics are
    all-reduced over the mesh axis before scoring, so every shard guides its
    expansion with the GLOBAL exploration state, and (2) each shard's top-k
    goal-nearest frontier slice is all_gathered into an exchange pool that a
    reserved fraction of every wave expands, with cross-shard global parent
    ids (see expansion_wave). Tree STORAGE stays shard-local. The collectives
    are one psum of two small histogram pytrees + one all_gather of
    k*(SAMPLE_DIM+2) floats per shard per iteration."""
    M = cfg.max_tree_size
    R = cfg.rollouts_per_iter

    with jax.named_scope("kgmt_scores"):
        if axis_name is not None:
            stats = (s.r1_total, s.r1_valid, s.r1_invalid, s.r1_avail,
                     s.r2_avail)
            g = jax.lax.psum(stats, axis_name)
            s_score = s._replace(
                r1_total=g[0], r1_valid=g[1], r1_invalid=g[2],
                r1_avail=(g[3] > 0).astype(jnp.int32),
                r2_avail=(g[4] > 0).astype(jnp.int32),
            )
        else:
            s_score = s
        r1_score, r1_threshold = update_region_scores(cfg, s_score)

    with jax.named_scope("kgmt_frontier"):
        # contiguous frontier: [frontier_lo, tree_size) — see KGMTState docs.
        # Frontier range and rollout target are fixed at ITERATION start:
        # sub-wave commits grow the tree tail without widening this
        # iteration's parent range (the reference likewise sizes its launch
        # from the pre-wave activeSize, KGMT.cu:151-158).
        frontier_lo0 = s.frontier_lo
        tree_size0 = s.tree_size
        frontier_size = tree_size0 - frontier_lo0
        n_target = jnp.minimum(cfg.fanout * frontier_size, M - tree_size0)
        if cfg.adaptive_waves:
            # full reference fan-out: ceil(target / R) sub-waves
            n_waves = (n_target + R - 1) // R
        else:
            n_target = jnp.minimum(n_target, R)
            n_waves = jnp.minimum(n_target, 1)  # one wave (0 if tree full)

    # --- cross-shard frontier exchange (sharded-tree mode, SURVEY P7) ------
    # Once per iteration (NOT per sub-wave: the sub-wave trip count differs
    # per shard, so collectives there would deadlock), every shard publishes
    # its exchange_k goal-nearest frontier nodes; the gathered pool feeds a
    # reserved fraction of each wave's slots so any shard can expand foreign
    # nodes — the collective analog of the reference's single compacted
    # frontier (KGMT.cu:139-147). Tree storage stays shard-local; parent
    # references become global ids (shard*M + slot).
    gid_base = 0
    pool = None
    if axis_name is not None:
        gid_base = jax.lax.axis_index(axis_name).astype(jnp.int32) * M
        if cfg.exchange_frac > 0.0:
            with jax.named_scope("kgmt_frontier_exchange"):
                idx = jnp.arange(M)
                in_frontier = (idx >= frontier_lo0) & (idx < tree_size0)
                d2x = ((s.tree_samples[:, 0] - goal[0]) ** 2
                       + (s.tree_samples[:, 1] - goal[1]) ** 2)
                d2x = jnp.where(in_frontier, d2x, jnp.inf)
                k = min(cfg.exchange_k, M)
                neg_best, cand = jax.lax.top_k(-d2x, k)
                ok = jnp.isfinite(-neg_best)  # padding when frontier < k
                cand = cand.astype(jnp.int32)
                cand_rows = s.tree_samples[cand]
                cand_ids = jnp.where(ok, gid_base + cand, -1)
                cand_costs = s.costs[cand]
                g_rows = jax.lax.all_gather(cand_rows, axis_name)
                g_ids = jax.lax.all_gather(cand_ids, axis_name)
                g_costs = jax.lax.all_gather(cand_costs, axis_name)
                pool = (g_rows.reshape(-1, SAMPLE_DIM), g_ids.reshape(-1),
                        g_costs.reshape(-1))

    it = s.itr
    sub_wave = partial(_wave_step, cfg, system, grid, obstacles, goal,
                       frontier_lo0, tree_size0, n_target, r1_score,
                       gid_base, pool)


    with jax.named_scope("kgmt_waves"):
        # r2_seen starts from the iteration-start availability snapshot
        # (the psum'd GLOBAL one in sharded mode) and accumulates arrivals
        # across sub-waves locally. In sharded mode the psum'd snapshot is
        # device-INVARIANT while the body's accumulation is varying, so the
        # carry is pvary-annotated up front (n_waves differs per shard — a
        # varying trip count is legal precisely because sub_wave contains no
        # collectives).
        wave_init = (jnp.zeros((), jnp.int32), s, s_score.r2_avail)
        if axis_name is not None:
            # promote to the union of ALL mesh axes the inputs vary over —
            # in a (scenario, tree) mesh the state is varying over both
            wave_init = pvary_like(wave_init, s, obstacles, goal,
                                   extra_axes=(axis_name,))
        _, s, _ = jax.lax.while_loop(
            lambda c: c[0] < n_waves, sub_wave, wave_init
        )

    stalled = s.tree_size == tree_size0
    if cfg.keep_frontier_on_stall:
        # The reference's frontier empties permanently if a wave accepts
        # nothing (parents cleared at KGMT.cu:378, no children set) and the
        # planner spins uselessly; retrying the same frontier with fresh
        # randomness is strictly better and is our default.
        new_frontier_lo = jnp.where(stalled, frontier_lo0, tree_size0)
    else:
        new_frontier_lo = tree_size0  # empty range when stalled

    out = s._replace(
        frontier_lo=new_frontier_lo,
        r1_score=r1_score,
        r1_threshold=r1_threshold,
        itr=it + 1,
        stalled=stalled,
        m_frontier_size=s.m_frontier_size.at[it].set(frontier_size),
        m_tree_size=s.m_tree_size.at[it].set(s.tree_size),
    )
    if axis_name is not None:
        # r1_score/r1_threshold come from psum'd (invariant-over-axis_name)
        # stats; normalize every leaf to the union of varying axes so the
        # caller's while_loop carry has one consistent VMA type.
        out = pvary_like(out, out, extra_axes=(axis_name,))
    return out


def kgmt_run(cfg: KGMTConfig, system, grid: RegionGrid, goal: Array,
             obstacles: Array, s0: KGMTState) -> KGMTState:
    """Iterate from an arbitrary starting state until first solution, tree
    full, stall (when retry is off), or iteration budget — the reference's
    host loop + termination tests (KGMT.cu:118-259) with the done-flag kept
    on device (no per-iteration host syncs). Starting from a checkpointed
    state continues the exact same trajectory (resume support).

    Structure: ONE while_loop whose trip is a single sub-wave, with
    iteration boundaries handled by predicated selects — NOT an outer
    iteration loop nesting an inner wave loop, whose inner while_loop
    materializes tree-sized carry copies every iteration (measured on the
    previous accelerator at 2.5x the flat form's iteration time). The
    per-wave math is the SAME ``_wave_step`` the nested
    ``kgmt_iteration`` uses (bitwise-identical results; kgmt_iteration
    remains the building block for the sharded-tree driver, whose
    collectives must sit in a lockstep per-iteration loop, and for
    plan_recorded's host-stepped dumps)."""
    M = cfg.max_tree_size
    R = cfg.rollouts_per_iter

    def outer_keep(s: KGMTState) -> Array:
        solved = (jnp.isfinite(s.cost_to_goal)
                  if cfg.stop_on_first_solution else jnp.zeros((), bool))
        full = s.tree_size >= M
        dead = jnp.zeros((), bool) if cfg.keep_frontier_on_stall else s.stalled
        return (s.itr < cfg.num_iterations) & ~solved & ~full & ~dead

    def cond(c) -> Array:
        s, w = c[0], c[1]
        # mid-iteration waves always run to completion (the nested design
        # likewise only checks termination between iterations)
        return (w > 0) | outer_keep(s)

    def body(c):
        s, w, fl0, ts0, n_tgt, r1_score, r1_thr, r2_seen = c
        is0 = w == 0
        with jax.named_scope("kgmt_scores"):
            # phase (a) belongs to wave 0; mid-iteration waves keep the
            # iteration-start context via the selects below. The formula is
            # 256-cell arithmetic — computing it every wave and selecting
            # costs less than any control flow would.
            f_score, f_thr = update_region_scores(cfg, s)
        r1_score = jnp.where(is0, f_score, r1_score)
        r1_thr = jnp.where(is0, f_thr, r1_thr)
        fl0 = jnp.where(is0, s.frontier_lo, fl0)
        ts0 = jnp.where(is0, s.tree_size, ts0)
        frontier_size = ts0 - fl0
        fresh_tgt = jnp.minimum(cfg.fanout * frontier_size, M - ts0)
        if not cfg.adaptive_waves:
            fresh_tgt = jnp.minimum(fresh_tgt, R)
        n_tgt = jnp.where(is0, fresh_tgt, n_tgt)
        r2_seen = jnp.where(is0, s.r2_avail, r2_seen)
        # under outer_keep: frontier nonempty and capacity left => n_tgt >= 1
        # => n_waves >= 1, so unconditionally running one wave per trip is
        # exactly the nested trip sequence
        n_waves = ((n_tgt + R - 1) // R if cfg.adaptive_waves
                   else jnp.minimum(n_tgt, jnp.int32(1)))
        it = s.itr
        w2, s2, r2_seen = _wave_step(cfg, system, grid, obstacles, goal,
                                     fl0, ts0, n_tgt, r1_score, 0, None,
                                     (w, s, r2_seen))
        last = w2 >= n_waves
        stalled = s2.tree_size == ts0
        if cfg.keep_frontier_on_stall:
            new_lo = jnp.where(stalled, fl0, ts0)
        else:
            new_lo = ts0
        s2 = s2._replace(
            frontier_lo=jnp.where(last, new_lo, s2.frontier_lo),
            r1_score=r1_score,
            r1_threshold=r1_thr,
            itr=it + last.astype(jnp.int32),
            stalled=jnp.where(last, stalled, s2.stalled),
            # idempotent across waves of one iteration (frontier_size is
            # iteration-constant; the last wave's tree_size is the final one)
            m_frontier_size=s2.m_frontier_size.at[it].set(frontier_size),
            m_tree_size=s2.m_tree_size.at[it].set(s2.tree_size),
        )
        return (s2, jnp.where(last, jnp.int32(0), w2), fl0, ts0, n_tgt,
                r1_score, r1_thr, r2_seen)

    zero = jnp.zeros((), jnp.int32)
    init = (s0, zero, zero, zero, zero, s0.r1_score, s0.r1_threshold,
            s0.r2_avail)
    return jax.lax.while_loop(cond, body, init)[0]


def kgmt_solve(cfg: KGMTConfig, system, grid: RegionGrid, init: Array,
               goal: Array, obstacles: Array, key: Array) -> KGMTState:
    """Full solve from scratch: seed the tree, then run to termination."""
    s0 = init_state(cfg, grid, init, key)
    return kgmt_run(cfg, system, grid, goal, obstacles, s0)


# ---------------------------------------------------------------------------
# Pathless feasibility mode (need_path=False)
# ---------------------------------------------------------------------------


class PathlessState(NamedTuple):
    """Feasibility-only planner state (``KGMTConfig.need_path=False``): the
    frontier lives in a [R, SAMPLE_DIM] buffer and the [M, SAMPLE_DIM] tree
    is NEVER written — tree-commit scatters dominated tree-mode device TTS
    on the previous accelerator, and a feasibility query (the
    reference's own semantics: break at FIRST solution, KGMT.cu:251-254)
    never reads the tree except to extract the path. Capacity semantics are
    preserved exactly through a virtual ``tree_size`` counter, so RNG
    streams, acceptance masks, iteration counts, and the final
    (solved, cost) are BITWISE identical to the tree mode whenever every
    iteration's accepted-children count fits the R-row frontier buffer
    (tests/test_kgmt.py::test_pathless_matches_tree_mode); wider frontiers
    keep only the FIRST R children in commit order (width caveat — the tree
    mode keeps them all; demo frontiers peak at ~3.6k < the default
    R=4096)."""

    # Frontier rows fused with their cost-from-root in ONE buffer (cols
    # 0..SAMPLE_DIM-1 = sample, col SAMPLE_DIM = cost): the wave then costs
    # ONE whole-row gather + ONE whole-row scatter instead of two of each.
    f_rows: Array  # f32 [R, SAMPLE_DIM + 1]
    n_frontier: Array  # i32 scalar — valid rows of f_rows
    tree_size: Array  # i32 scalar — VIRTUAL (capacity-clamp parity only)
    # Region statistics: same guidance state as the tree mode, minus the
    # r2 total/valid/invalid counters (observability-only there — behavior
    # reads only r2_avail for coverage, virgin-cell acceptance and the
    # r2_seen snapshot).
    r1_total: Array
    r1_valid: Array
    r1_invalid: Array
    r1_avail: Array
    r1_score: Array
    r2_avail: Array
    r1_threshold: Array
    cost_to_goal: Array  # f32 scalar, +inf until solved
    itr: Array
    key: Array
    stalled: Array
    m_frontier_size: Array
    m_valid: Array
    m_accepted: Array
    m_tree_size: Array


def init_pathless_state(cfg: KGMTConfig, grid: RegionGrid, init: Array,
                        key: Array) -> PathlessState:
    """Root seeding, mirroring ``init_state`` (KGMT.cu:85-97) with the root
    sample in frontier row 0 instead of tree slot 0."""
    R = cfg.rollouts_per_iter
    r1_0, r2_0 = grid.region_indices(init[0:2][None, :])
    r1_0, r2_0 = r1_0[0], r2_0[0]
    one = (r1_0 >= 0).astype(jnp.int32)
    one_r2 = (r2_0 >= 0).astype(jnp.int32)
    r1_0 = jnp.maximum(r1_0, 0)
    r2_0 = jnp.maximum(r2_0, 0)
    zeros_r1 = jnp.zeros(cfg.num_r1, jnp.int32)
    it = max(cfg.num_iterations, 1)
    return PathlessState(
        f_rows=jnp.zeros((R, SAMPLE_DIM + 1), jnp.float32).at[0, :SAMPLE_DIM]
        .set(init),
        n_frontier=jnp.ones((), jnp.int32),
        tree_size=jnp.ones((), jnp.int32),
        r1_total=zeros_r1.at[r1_0].set(one),
        r1_valid=zeros_r1.at[r1_0].set(one),
        r1_invalid=zeros_r1,
        r1_avail=zeros_r1.at[r1_0].set(one),
        r1_score=jnp.ones(cfg.num_r1, jnp.float32),
        r2_avail=jnp.zeros(cfg.num_r2, jnp.int32).at[r2_0].set(one_r2),
        r1_threshold=jnp.zeros((), jnp.float32),
        cost_to_goal=jnp.array(jnp.inf, jnp.float32),
        itr=jnp.zeros((), jnp.int32),
        key=key,
        stalled=jnp.zeros((), bool),
        m_frontier_size=jnp.zeros(it, jnp.int32),
        m_valid=jnp.zeros(it, jnp.int32),
        m_accepted=jnp.zeros(it, jnp.int32),
        m_tree_size=jnp.zeros(it, jnp.int32),
    )


def kgmt_run_pathless(cfg: KGMTConfig, system, grid: RegionGrid, goal: Array,
                      obstacles: Array, s0: PathlessState) -> PathlessState:
    """The flat (iteration x wave) while_loop of ``kgmt_run`` with the tree
    commit replaced by an R-row next-frontier buffer write: phases (a)-(e)
    of the reference loop (KGMT.cu:118-292) minus path storage. RNG
    derivation, parent round-robin order, acceptance, capacity clamping and
    termination all mirror the tree driver step for step (the stats/accept
    block is literally the same function), which is what makes the
    equivalence test bitwise rather than statistical."""
    M = cfg.max_tree_size
    R = cfg.rollouts_per_iter

    def outer_keep(s: PathlessState) -> Array:
        solved = (jnp.isfinite(s.cost_to_goal)
                  if cfg.stop_on_first_solution else jnp.zeros((), bool))
        full = s.tree_size >= M
        dead = jnp.zeros((), bool) if cfg.keep_frontier_on_stall else s.stalled
        return (s.itr < cfg.num_iterations) & ~solved & ~full & ~dead

    def cond(c) -> Array:
        s, w = c[0], c[1]
        return (w > 0) | outer_keep(s)

    def body(c):
        s, w, n_tgt, r1_score, r1_thr, r2_seen, nxt_rows, n_next = c
        is0 = w == 0
        with jax.named_scope("kgmt_scores"):
            f_score, f_thr = update_region_scores(cfg, s)
        r1_score = jnp.where(is0, f_score, r1_score)
        r1_thr = jnp.where(is0, f_thr, r1_thr)
        n_frontier = s.n_frontier
        fresh_tgt = jnp.minimum(cfg.fanout * n_frontier, M - s.tree_size)
        if not cfg.adaptive_waves:
            fresh_tgt = jnp.minimum(fresh_tgt, R)
        n_tgt = jnp.where(is0, fresh_tgt, n_tgt)
        r2_seen = jnp.where(is0, s.r2_avail, r2_seen)
        n_next = jnp.where(is0, jnp.int32(0), n_next)
        n_waves = ((n_tgt + R - 1) // R if cfg.adaptive_waves
                   else jnp.minimum(n_tgt, jnp.int32(1)))
        it = s.itr

        # --- expansion: parents round-robin over the register frontier ----
        with jax.named_scope("kgmt_expand"):
            slot = jnp.arange(R, dtype=jnp.int32)
            gslot = w * R + slot
            slot_active = gslot < n_tgt
            parent_idx = gslot % jnp.maximum(n_frontier, 1)
            if cfg.goal_bias > 0.0:
                # Goal-biased parent selection, exactly the tree driver's
                # rule (expansion_wave): the tree mode's top-k already
                # restricts to the frontier range, which here IS the whole
                # buffer — so a top-k over R rows is the same selection at
                # a fraction of the cost (R vs M candidates).
                with jax.named_scope("kgmt_goal_bias_topk"):
                    in_f = slot < n_frontier
                    d2b = ((s.f_rows[:, 0] - goal[0]) ** 2
                           + (s.f_rows[:, 1] - goal[1]) ** 2)
                    d2b = jnp.where(in_f, d2b, jnp.inf)
                    k_r = min(cfg.goal_bias_k, R)
                    neg_best, near = jax.lax.top_k(-d2b, k_r)
                    n_biased = int(round(cfg.goal_bias * R))
                    # the CYCLING modulus must be the tree driver's k
                    # (min(goal_bias_k, M)) for bitwise parity when
                    # goal_bias_k > R: tree-mode entries past the frontier
                    # are inf padding (ok=False -> round-robin fallback),
                    # and the frontier always fits R rows here, so entries
                    # j >= k_r are padding by construction
                    k_m = min(cfg.goal_bias_k, M)
                    j = jnp.arange(n_biased) % k_m
                    biased = near[jnp.minimum(j, k_r - 1)].astype(jnp.int32)
                    ok = (j < k_r) & jnp.isfinite(
                        -neg_best)[jnp.minimum(j, k_r - 1)]
                    parent_idx = parent_idx.at[:n_biased].set(
                        jnp.where(ok, biased, parent_idx[:n_biased]))
            parent_rows = s.f_rows[parent_idx]  # one fused whole-row gather
            parent_cost = parent_rows[:, SAMPLE_DIM]
            x0 = parent_rows[:, : system.state_dim]
            key_iter = jax.random.fold_in(s.key, it)
            key_wave = jax.lax.cond(
                w == 0, lambda: key_iter,
                lambda: jax.random.fold_in(key_iter, w))
            k_ctrl, k_accept = jax.random.split(key_wave)
            x1, controls, valid = _expand_rollout(cfg, system, k_ctrl, x0,
                                                  obstacles)
            valid = valid & slot_active
            samples1 = jnp.concatenate([x1, controls], axis=-1)

        d1, d2, accept, r2_seen = _region_stats_and_accept(
            cfg, grid, x1, slot_active, valid, r1_score, r2_seen, k_accept)

        # --- commit into the next-frontier registers (no tree write) ------
        with jax.named_scope("kgmt_commit_pathless"):
            accept_i = accept.astype(jnp.int32)
            accept_pos = jnp.cumsum(accept_i) - accept_i
            child_virt = s.tree_size + accept_pos
            within = accept & (child_virt < M)
            n_acc = jnp.minimum(accept_i.sum(), M - s.tree_size)
            child_cost = parent_cost + controls[:, -1]
            # rows past the R-buffer width fall out of bounds -> dropped;
            # sample + cost committed by ONE fused whole-row scatter
            dst = jnp.where(within, n_next + accept_pos, R)
            child_rows = jnp.concatenate([samples1, child_cost[:, None]],
                                         axis=-1)
            nxt_rows = nxt_rows.at[dst].set(child_rows, mode="drop")
            n_next = jnp.minimum(n_next + n_acc, R)

        # --- goal check (inGoalRegion, KGMT.cu:635-638) -------------------
        with jax.named_scope("kgmt_goal"):
            d2g = (x1[:, 0] - goal[0]) ** 2 + (x1[:, 1] - goal[1]) ** 2
            in_goal = within & (d2g < cfg.goal_threshold**2)
            goal_costs = jnp.where(in_goal, child_cost, jnp.inf)
            best_cost = goal_costs.min()
            cost_to_goal = jnp.minimum(best_cost, s.cost_to_goal)

        last = (w + 1) >= n_waves
        stalled = n_next == 0
        if cfg.keep_frontier_on_stall:
            take_next = last & ~stalled
        else:
            take_next = last  # stalled -> empty frontier, loop stops
        s2 = s._replace(
            f_rows=jnp.where(take_next, nxt_rows, s.f_rows),
            n_frontier=jnp.where(take_next, n_next, s.n_frontier),
            tree_size=s.tree_size + n_acc,
            r1_total=s.r1_total + d1[:, 0],
            r1_valid=s.r1_valid + d1[:, 1],
            r1_invalid=s.r1_invalid + (d1[:, 0] - d1[:, 1]),
            r1_avail=s.r1_avail | (d1[:, 1] > 0).astype(jnp.int32),
            r2_avail=s.r2_avail | (d2[:, 1] > 0).astype(jnp.int32),
            r1_score=r1_score,
            r1_threshold=r1_thr,
            cost_to_goal=cost_to_goal,
            itr=it + last.astype(jnp.int32),
            stalled=jnp.where(last, stalled, s.stalled),
            m_frontier_size=s.m_frontier_size.at[it].set(n_frontier),
            m_valid=s.m_valid.at[it].add(valid.sum()),
            m_accepted=s.m_accepted.at[it].add(n_acc),
            m_tree_size=s.m_tree_size.at[it].set(s.tree_size + n_acc),
        )
        return (s2, jnp.where(last, jnp.int32(0), w + 1), n_tgt, r1_score,
                r1_thr, r2_seen, nxt_rows, n_next)

    zero = jnp.zeros((), jnp.int32)
    init = (s0, zero, zero, s0.r1_score, s0.r1_threshold, s0.r2_avail,
            jnp.zeros((R, SAMPLE_DIM + 1), jnp.float32), zero)
    return jax.lax.while_loop(cond, body, init)[0]


def kgmt_solve_pathless(cfg: KGMTConfig, system, grid: RegionGrid,
                        init: Array, goal: Array, obstacles: Array,
                        key: Array) -> PathlessState:
    """Full feasibility-only solve (need_path=False)."""
    s0 = init_pathless_state(cfg, grid, init, key)
    return kgmt_run_pathless(cfg, system, grid, goal, obstacles, s0)


def extract_path(cfg: KGMTConfig, s: KGMTState) -> tuple[Array, Array, Array]:
    """Walk parent pointers from the goal node to the root, on device.

    The tree depth grows by at most 1 per iteration (the frontier is exactly
    the nodes committed by the previous wave, KGMT.cu:586), so
    num_iterations + 1 bounds the path length. Returns (nodes, samples, length)
    with fixed shapes; entries beyond ``length`` are -1 / zeros, and the walk
    yields goal -> root order reversed to root -> goal.
    """
    L = cfg.num_iterations + 1

    def step(node, _):
        nxt = jnp.where(node >= 0, s.tree_parent[jnp.maximum(node, 0)], -1)
        return nxt, node

    _, rev_nodes = jax.lax.scan(step, s.goal_node, None, length=L)
    # rev_nodes is goal, parent, ..., root, -1, -1...; reverse and left-pack.
    length = (rev_nodes >= 0).sum()
    idx = jnp.arange(L)
    src = length - 1 - idx  # position in rev_nodes for output slot idx
    nodes = jnp.where(idx < length, rev_nodes[jnp.maximum(src, 0)], -1)
    samples = jnp.where(
        (nodes >= 0)[:, None], s.tree_samples[jnp.maximum(nodes, 0)], 0.0
    )
    return nodes, samples, length


# ---------------------------------------------------------------------------
# Host-facing planner
# ---------------------------------------------------------------------------


class KGMT(Planner):
    """Host-facing flagship planner. Owns the compiled solve for one static
    config; ``plan`` runs it end-to-end with a single device->host fetch."""

    def __init__(self, config: KGMTConfig | None = None, system=None):
        self.config = config or KGMTConfig()
        self.system = system or get_system(
            self.config.system,
            **({"agent_length": self.config.agent_length}
               if self.config.system in ("bicycle", "car") else {}),
        )
        self.grid = RegionGrid(
            width=self.config.width, height=self.config.height,
            N=self.config.N, n=self.config.n,
        )
        cfg, sys_, grid = self.config, self.system, self.grid

        if cfg.need_path:
            @jax.jit
            def _solve(init, goal, obstacles, key):
                final = kgmt_solve(cfg, sys_, grid, init, goal, obstacles,
                                   key)
                nodes, samples, length = extract_path(cfg, final)
                return final, nodes, samples, length

            @jax.jit
            def _resume(s0, goal, obstacles):
                final = kgmt_run(cfg, sys_, grid, goal, obstacles, s0)
                nodes, samples, length = extract_path(cfg, final)
                return final, nodes, samples, length
        else:
            # feasibility-only: no tree, no path — empty path placeholders
            def _no_path(final):
                L = cfg.num_iterations + 1
                return (jnp.full(L, -1, jnp.int32),
                        jnp.zeros((L, SAMPLE_DIM), jnp.float32),
                        jnp.zeros((), jnp.int32))

            @jax.jit
            def _solve(init, goal, obstacles, key):
                final = kgmt_solve_pathless(cfg, sys_, grid, init, goal,
                                            obstacles, key)
                return (final,) + _no_path(final)

            @jax.jit
            def _resume(s0, goal, obstacles):
                final = kgmt_run_pathless(cfg, sys_, grid, goal, obstacles,
                                          s0)
                return (final,) + _no_path(final)

        self._solve = _solve
        self._resume = _resume

    # -- Planner interface -------------------------------------------------
    def plan(self, scenario: Scenario, seed: int | None = None) -> KGMTResult:
        cfg = self.config
        obstacles, _ = scenario.padded_obstacles(cfg.max_obstacles)
        key = jax.random.key(cfg.seed if seed is None else seed)
        t0 = time.perf_counter()
        final, nodes, samples, length = self._solve(
            jnp.asarray(scenario.init), jnp.asarray(scenario.goal),
            jnp.asarray(obstacles), key,
        )
        final = jax.block_until_ready(final)
        wall = time.perf_counter() - t0
        return self._build_result(final, nodes, samples, length, wall)

    def resume(self, state: KGMTState | PathlessState,
               scenario: Scenario) -> KGMTResult:
        """Continue a solve from a (possibly checkpointed) state — exact
        resume, including RNG (io.checkpoint round-trips the full pytree).
        The state type must match ``config.need_path`` (load_checkpoint
        returns whichever type the file holds)."""
        cfg = self.config
        expected = KGMTState if cfg.need_path else PathlessState
        if not isinstance(state, expected):
            raise ValueError(
                f"checkpoint holds {type(state).__name__} but this planner "
                f"is configured with need_path={cfg.need_path} (expects "
                f"{expected.__name__}); construct KGMT with the matching "
                "config to resume it")
        obstacles, _ = scenario.padded_obstacles(cfg.max_obstacles)
        t0 = time.perf_counter()
        final, nodes, samples, length = self._resume(
            state, jnp.asarray(scenario.goal), jnp.asarray(obstacles)
        )
        final = jax.block_until_ready(final)
        wall = time.perf_counter() - t0
        return self._build_result(final, nodes, samples, length, wall)

    def _build_result(self, final, nodes, samples, length, wall) -> KGMTResult:
        # ONE batched device->host fetch instead of a synchronising
        # transfer per field.
        (cost, length_i, it, m_frontier, m_valid, m_accepted, m_tree,
         r1_thr, tree_size_i, nodes, samples) = jax.device_get(
            (final.cost_to_goal, length, final.itr, final.m_frontier_size,
             final.m_valid, final.m_accepted, final.m_tree_size,
             final.r1_threshold, final.tree_size, nodes, samples))
        cost = float(cost)
        solved = np.isfinite(cost)
        length_i = int(length_i)
        it = int(it)
        metrics = {
            "frontier_size": m_frontier[:it],
            "valid": m_valid[:it],
            "accepted": m_accepted[:it],
            "tree_size": m_tree[:it],
            "r1_threshold": float(r1_thr),
        }
        return KGMTResult(
            solved=bool(solved),
            cost=cost if solved else float("inf"),
            iterations=it,
            tree_size=int(tree_size_i),
            wall_time_s=wall,
            path=np.asarray(samples)[:length_i],
            path_nodes=np.asarray(nodes)[:length_i],
            state=final,
            metrics=metrics,
        )

    def plan_recorded(self, scenario: Scenario, out_dir: str,
                      seed: int | None = None, dump_every: int = 1,
                      checkpoint_every: int | None = None) -> KGMTResult:
        """Step-by-step solve with per-iteration artifact dumps — the debug
        workflow the reference left commented out (KGMT.cu:263-291, feeding
        visualizationKGMT_Steps.m): iterations run one jitted step at a time
        on the host loop, dumping ``samples<i>.csv`` / ``parents<i>.csv`` /
        ``R1Scores<i>.csv``-style files under ``out_dir`` and (optionally)
        full checkpoints every ``checkpoint_every`` iterations. Slower than
        plan() (one dispatch per iteration) — for analysis, not production."""
        import pathlib

        from cudasbmp_jax.io.checkpoint import save_checkpoint
        from cudasbmp_jax.io.csv import write_csv

        cfg = self.config
        if not cfg.need_path:
            raise ValueError("plan_recorded needs the tree-mode planner "
                             "(need_path=True): its artifacts ARE the tree")
        out = pathlib.Path(out_dir)
        for sub in ("Samples", "Parents", "R1Scores", "R1Avail", "R1", "G",
                    "UnexploredSamples", "UParentIdx"):
            (out / sub).mkdir(parents=True, exist_ok=True)
        obstacles, _ = scenario.padded_obstacles(cfg.max_obstacles)
        obstacles = jnp.asarray(obstacles)
        goal = jnp.asarray(scenario.goal)
        key = jax.random.key(cfg.seed if seed is None else seed)
        state = init_state(cfg, self.grid, jnp.asarray(scenario.init), key)
        step = jax.jit(
            lambda s: kgmt_iteration(cfg, self.system, self.grid, obstacles,
                                     goal, s)
        )
        t0 = time.perf_counter()
        for i in range(cfg.num_iterations):
            state = step(state)
            if i % dump_every == 0:
                it = i + 1
                # staging buffer (KGMT.cu:269-274, Data/UnexploredSamples):
                # carried in the state like the reference's device vectors
                write_csv(np.asarray(state.u_samples),
                          out / "UnexploredSamples"
                          / f"unexploredSamples{it}.csv", SAMPLE_DIM)
                write_csv(np.asarray(state.u_parent),
                          out / "UParentIdx" / f"uParentIdx{it}.csv")
                write_csv(np.asarray(state.tree_samples),
                          out / "Samples" / f"samples{it}.csv", SAMPLE_DIM)
                write_csv(np.asarray(state.tree_parent),
                          out / "Parents" / f"parents{it}.csv")
                write_csv(np.asarray(state.r1_score),
                          out / "R1Scores" / f"R1Scores{it}.csv")
                write_csv(np.asarray(state.r1_avail),
                          out / "R1Avail" / f"R1Avail{it}.csv")
                write_csv(np.asarray(state.r1_total), out / "R1" / f"R1{it}.csv")
                write_csv(np.asarray(frontier_mask(state, cfg.max_tree_size)
                                     ).astype(np.int32),
                          out / "G" / f"G{it}.csv")
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                save_checkpoint(state, out / f"checkpoint_{i + 1}.npz")
            # same termination tests as kgmt_run's cond (incl. the stall
            # check when frontier retry is disabled and the anytime flag)
            solved_now = bool(np.isfinite(np.asarray(state.cost_to_goal)))
            if (cfg.stop_on_first_solution and solved_now) or \
               int(state.tree_size) >= cfg.max_tree_size or \
               (not cfg.keep_frontier_on_stall and bool(state.stalled)):
                break
        wall = time.perf_counter() - t0
        nodes, samples, length = jax.jit(partial(extract_path, cfg))(state)
        return self._build_result(jax.block_until_ready(state), nodes, samples,
                                  length, wall)

    def generate_random_tree(self, scenario: Scenario, num_rollouts: int):
        """Unguided random-tree probe (Planner.cuh:10) — delegates to the
        NaivePlanner equivalent for interface completeness."""
        from cudasbmp_jax.planners.naive import NaivePlanner

        return NaivePlanner(self.config, self.system).generate_random_tree(
            scenario, num_rollouts
        )
