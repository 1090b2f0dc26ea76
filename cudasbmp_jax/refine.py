"""Differentiable trajectory refinement — the local-optimization stage on top
of the KGMT feasibility search.

The reference stops at the first feasible trajectory (feasibility search, not
optimization — KGMT.cu:251-254). BASELINE.json's north star calls for "local
trajectory-refinement ... blocks"; the realization here is gradient
descent THROUGH the rollout: the Euler integration of the control sequence is
pure jax, so d(cost)/d(controls) is one jax.grad away, runs on the device,
and vmaps over many trajectories at once (refining a whole multi-query batch
in one jitted step).

Objective: minimize total trajectory time subject to staying collision-free,
in-bounds and ending in the goal region — enforced with smooth hinge
penalties. Controls stay inside their sampling box via a tanh
reparameterization, so refined trajectories remain replayable by the same
rollout machinery (and are re-validated with the exact hard checker before
being accepted)."""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.config import KGMTConfig
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.systems.base import System


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    iterations: int = 400
    learning_rate: float = 1e-3
    clip_norm: float = 1.0  # chained-Euler gradients explode; clip globally
    collision_weight: float = 30.0
    goal_weight: float = 10.0
    time_weight: float = 1.0
    margin: float = 0.05  # extra clearance demanded from obstacles/bounds


def _soft_penetration(px, py, obstacles, margin, wts):
    """Smooth penetration depth of points into (margin-inflated) obstacles.
    px, py: [T]; obstacles [K, 4]; wts [T] per-point weights (0 silences
    padded zombie edges in batched refinement). Returns scalar penalty."""
    ox0, oy0, ox1, oy1 = (obstacles[:, i] for i in range(4))
    # signed distance to box (negative inside); smooth-min over axes
    dx = jnp.maximum(ox0[None, :] - margin - px[:, None],
                     px[:, None] - ox1[None, :] - margin)
    dy = jnp.maximum(oy0[None, :] - margin - py[:, None],
                     py[:, None] - oy1[None, :] - margin)
    outside = jnp.maximum(dx, dy)  # >0 outside, <0 inside
    return jnp.sum((jax.nn.relu(-outside) ** 2) * wts[:, None])


def _unroll_positions(system: System, x0, controls, num_disc):
    """Fine-grained positions of the whole trajectory: [L*num_disc, 2].
    controls [L, 3]."""

    def edge(state, control):
        a_steer, dur = control[:-1], control[-1]
        dt = dur / num_disc

        def step(s, _):
            s2 = system.step(s, a_steer, dt)
            return s2, s2[:2]

        state, pts = jax.lax.scan(step, state, None, length=num_disc)
        return state, pts

    _, pts = jax.lax.scan(edge, x0, controls)
    return pts.reshape(-1, 2)


def _loss(system, cfg: KGMTConfig, rcfg: RefineConfig, x0, goal_xy, obstacles,
          raw, lo, hi, mask):
    controls = lo + (hi - lo) * jax.nn.sigmoid(raw)  # box-constrained
    # masked (padding) edge slots are zero-motion: duration 0 freezes the
    # unroll at the real path's endpoint, so batched paths of different
    # lengths share one static Lmax without zombie edges drifting past the
    # goal or accruing phantom penalties
    controls = controls.at[:, -1].set(
        jnp.where(mask, controls[:, -1], 0.0))
    pts = _unroll_positions(system, x0, controls, cfg.num_disc)
    time_cost = controls[:, -1].sum()
    # zero-weight the points of padded edges so the batched objective is
    # IDENTICAL to the single-path one (zombie points sit frozen at the
    # endpoint; without the weights they would multiply its penalties)
    wts = jnp.repeat(mask.astype(pts.dtype), cfg.num_disc)
    collision = _soft_penetration(pts[:, 0], pts[:, 1], obstacles,
                                  rcfg.margin, wts)
    oob = (
        jnp.sum(jax.nn.relu(rcfg.margin - pts[:, 0]) ** 2 * wts)
        + jnp.sum(jax.nn.relu(pts[:, 0] - (cfg.width - rcfg.margin)) ** 2 * wts)
        + jnp.sum(jax.nn.relu(rcfg.margin - pts[:, 1]) ** 2 * wts)
        + jnp.sum(jax.nn.relu(pts[:, 1] - (cfg.height - rcfg.margin)) ** 2 * wts)
    )
    end = pts[-1]
    goal_dist = jnp.sum((end - goal_xy) ** 2)
    # keep the endpoint strictly inside the goal region (soft)
    goal_pen = jax.nn.relu(
        jnp.sqrt(goal_dist + 1e-9) - 0.8 * cfg.goal_threshold
    ) ** 2
    return (rcfg.time_weight * time_cost
            + rcfg.collision_weight * (collision + oob)
            + rcfg.goal_weight * goal_pen)


def _refine_core(system, cfg: KGMTConfig, rcfg: RefineConfig, x0, goal_xy,
                 obstacles, controls0, mask):
    lo = jnp.asarray(system.control_spec.lo)
    hi = jnp.asarray(system.control_spec.hi)
    eps = 1e-4
    c0 = jnp.clip(controls0, lo + eps, hi - eps)
    raw0 = jnp.log((c0 - lo) / (hi - c0))  # inverse sigmoid

    loss_fn = lambda raw: _loss(system, cfg, rcfg, x0, goal_xy, obstacles,
                                jnp.where(mask[:, None], raw, raw0), lo, hi,
                                mask)
    grad_fn = jax.value_and_grad(loss_fn)

    def opt_step(carry, _):
        raw, m, v, t, best_raw, best_loss = carry
        loss, g = grad_fn(raw)
        # nonmonotone optimization over chaotic dynamics: remember the best
        better = loss < best_loss
        best_raw = jnp.where(better, raw, best_raw)
        best_loss = jnp.where(better, loss, best_loss)
        g = jnp.where(mask[:, None], g, 0.0)
        gn = jnp.sqrt(jnp.sum(g * g) + 1e-12)
        g = g * jnp.minimum(1.0, rcfg.clip_norm / gn)
        # Adam
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9 ** (t + 1))
        vhat = v / (1 - 0.999 ** (t + 1))
        raw = raw - rcfg.learning_rate * mhat / (jnp.sqrt(vhat) + 1e-8)
        return (raw, m, v, t + 1, best_raw, best_loss), loss

    init = (raw0, jnp.zeros_like(raw0), jnp.zeros_like(raw0), 0,
            raw0, jnp.asarray(jnp.inf))
    (raw, _, _, _, best_raw, best_loss), losses = jax.lax.scan(
        opt_step, init, None, length=rcfg.iterations
    )
    final_loss = loss_fn(raw)
    raw = jnp.where(final_loss < best_loss, raw, best_raw)
    refined = lo + (hi - lo) * jax.nn.sigmoid(raw)
    refined = jnp.where(mask[:, None], refined, controls0)
    return refined, losses


_refine_jit = partial(jax.jit, static_argnames=("system", "cfg", "rcfg"))(
    _refine_core
)


@partial(jax.jit, static_argnames=("system", "cfg", "rcfg"))
def _refine_batch_jit(system, cfg: KGMTConfig, rcfg: RefineConfig, x0s,
                      goal_xys, obstacles, controls0, masks):
    """One jitted program refining a whole multi-query batch: vmap of the
    Adam-through-rollout core over problems (north-star "local trajectory-
    refinement QP blocks" batched over the scenario axis). obstacles is
    [B, K, 4] (per-problem) — broadcast shared sets outside."""
    refined, losses = jax.vmap(
        lambda x0, g, obs, c0, m: _refine_core(system, cfg, rcfg, x0, g, obs,
                                               c0, m)
    )(x0s, goal_xys, obstacles, controls0, masks)
    return refined, losses


@partial(jax.jit, static_argnames=("system", "cfg"))
def _revalidate_jit(system, cfg: KGMTConfig, x0s, goal_xys, obstacles,
                    controls, masks):
    """Hard re-validation of refined control sequences with the EXACT
    checker, as ONE device program: lax.scan over the edge chain (each
    edge's start state is the previous edge's end state), rollout_batch
    vmapped over problems inside each step — replaces the former per-edge
    host loop of device calls. Edges beyond a path's length mask pass
    through without moving the state. Returns (per_edge_states
    [B, L, S] — the exact checker's states, frozen at the first failing step
    like the reference's in-rollout break — all_valid [B], in_goal [B])."""

    def edge(carry, inp):
        states, ok = carry  # [B, S], [B]
        ctrl, m = inp  # [B, C+1], [B]

        def one(x0, c, obs):
            x1, valid = rollout_batch(
                system, x0[None], c[None], cfg.num_disc, obs,
                cfg.width, cfg.height, footprint=cfg.footprint)
            return x1[0], valid[0]

        x1, valid = jax.vmap(one)(states, ctrl, obstacles)
        states = jnp.where(m[:, None], x1, states)
        ok = ok & (valid | ~m)
        return (states, ok), states

    B = x0s.shape[0]
    init = (x0s, jnp.ones(B, bool))
    (end, ok), per_edge = jax.lax.scan(
        edge, init, (jnp.swapaxes(controls, 0, 1), jnp.swapaxes(masks, 0, 1))
    )
    d = jnp.linalg.norm(end[:, :2] - goal_xys, axis=-1)
    return jnp.swapaxes(per_edge, 0, 1), ok, d < cfg.goal_threshold


def refine_path(system, cfg: KGMTConfig, path: np.ndarray, goal: np.ndarray,
                obstacles: np.ndarray, rcfg: RefineConfig | None = None,
                ) -> dict:
    """Refine a solved path's control sequence. path: [L, SAMPLE_DIM] from
    KGMTResult (root first). Returns dict with refined controls, states, cost
    before/after, and whether the refined trajectory passes the HARD validity
    check (if not, the caller should keep the original)."""
    rcfg = rcfg or RefineConfig()
    L = len(path) - 1
    if L < 1:
        raise ValueError("path must contain at least one edge")
    x0 = jnp.asarray(path[0][: system.state_dim])
    controls0 = jnp.asarray(path[1:, system.state_dim:])
    goal_xy = jnp.asarray(goal[:2])
    obstacles_j = jnp.asarray(obstacles)
    mask = jnp.ones(L, bool)

    refined, losses = _refine_jit(system, cfg, rcfg, x0, goal_xy, obstacles_j,
                                  controls0, mask)

    # hard re-validation: replay the refined edge chain with the exact
    # checker in ONE device dispatch (scan over edges; formerly a host loop
    # of L separate device calls). The scan's per-edge end states double as
    # the returned node states — frozen at the first failing step when
    # valid=False, exactly like the reference's in-rollout break
    edge_states, ok, in_goal = _revalidate_jit(
        system, cfg, x0[None], goal_xy[None], obstacles_j[None],
        refined[None], mask[None])
    states = jnp.concatenate([x0[None], edge_states[0]], axis=0)
    return {
        "controls": np.asarray(refined),
        "states": np.asarray(states),
        "cost_before": float(np.asarray(controls0[:, -1]).sum()),
        "cost_after": float(np.asarray(refined[:, -1]).sum()),
        "valid": bool(ok[0] and in_goal[0]),
        "losses": np.asarray(losses),
    }


def refine_batch(system, cfg: KGMTConfig, paths: np.ndarray,
                 path_lengths: np.ndarray, goals: np.ndarray,
                 obstacles: np.ndarray, rcfg: RefineConfig | None = None,
                 ) -> dict:
    """Refine a whole multi-query batch of solved paths in ONE jitted
    program; the batch axis is the same scenario axis the multi-query
    planner shards.

    paths: [B, Lmax, SAMPLE_DIM] (MultiQueryResult.paths layout: row 0 is the
    root sample, rows 1..length-1 carry each edge's controls in columns
    state_dim:); path_lengths: [B] node counts (0 or 1 = unsolved, skipped);
    goals: [B, SAMPLE_DIM]; obstacles: [B, K, 4] or shared [K, 4].

    Returns dict of arrays: refined controls [B, Lmax-1, C+1], cost_before/
    cost_after [B], valid [B] (hard exact-checker re-validation AND goal
    containment), improved [B] (valid AND cost_after < cost_before). Callers
    should keep the original path where ``improved`` is False.
    """
    rcfg = rcfg or RefineConfig()
    B, Lmax = paths.shape[0], paths.shape[1]
    if Lmax < 2:
        raise ValueError("paths must have room for at least one edge")
    S = system.state_dim
    x0s = jnp.asarray(paths[:, 0, :S])
    controls0 = jnp.asarray(paths[:, 1:, S:])  # [B, Lmax-1, C+1]
    goal_xys = jnp.asarray(goals[:, :2])
    obstacles = np.asarray(obstacles)
    if obstacles.ndim == 2:
        obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
    obstacles_j = jnp.asarray(obstacles)
    lengths = jnp.asarray(path_lengths, jnp.int32)
    masks = jnp.arange(Lmax - 1)[None, :] < (lengths[:, None] - 1)

    refined, losses = _refine_batch_jit(system, cfg, rcfg, x0s, goal_xys,
                                        obstacles_j, controls0, masks)
    _, ok, in_goal = _revalidate_jit(system, cfg, x0s, goal_xys, obstacles_j,
                                     refined, masks)
    cost_before = (controls0[..., -1] * masks).sum(axis=-1)
    cost_after = (refined[..., -1] * masks).sum(axis=-1)
    solved = np.asarray(lengths) >= 2
    valid = np.asarray(ok) & np.asarray(in_goal) & solved
    cost_before = np.asarray(cost_before)
    cost_after = np.asarray(cost_after)
    return {
        "controls": np.asarray(refined),
        "cost_before": cost_before,
        "cost_after": cost_after,
        "valid": valid,
        "improved": valid & (cost_after < cost_before),
        "losses": np.asarray(losses),
    }
