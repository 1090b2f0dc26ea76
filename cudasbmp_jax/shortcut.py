"""Sampling-based kinodynamic path shortcutting.

The reference returns the FIRST feasible trajectory and stops (KGMT.cu:
251-254); its cost metric is trajectory time. This module adds the classic
post-processing stage it lacks, in batched form: repeatedly pick a node i
on the path, fire K random rollouts from it (the same fused propagate+check
used everywhere), replay the path suffix after a later node j from each
candidate's end state, and splice in the best candidate that (a) keeps every
replayed edge collision-free, (b) still ends in the goal region, and (c)
reduces total trajectory time. Unlike geometric shortcutting, no two-point
steering function is needed — exactness comes from replaying the stored
suffix controls from the new state, which is the same replay invariant the
tree itself guarantees (SURVEY.md §4.2).

One round = one jitted fixed-shape step (candidates and suffix replay all
batched); the round loop runs on the host with a single compiled function.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.config import KGMTConfig, SAMPLE_DIM
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.systems.base import System


@dataclasses.dataclass(frozen=True)
class ShortcutConfig:
    rounds: int = 64
    candidates: int = 256  # K random rollouts per round
    min_gain: float = 1e-4


@partial(jax.jit, static_argnames=("system", "cfg", "K", "N"))
def _shortcut_round(system, cfg: KGMTConfig, K: int, N: int,
                    nodes, n_edges, goal_xy, obstacles, key, min_gain):
    """One shortcut attempt. nodes [N, SAMPLE_DIM] (node 0 = root, node k's
    sample = state after edge k + the control that produced it), n_edges
    scalar. Returns updated (nodes, n_edges)."""
    k_i, k_j, k_ctrl = jax.random.split(key, 3)
    # pick i in [0, n_edges-2], j in [i+2, n_edges]
    can = n_edges >= 2
    i = jax.random.randint(k_i, (), 0, jnp.maximum(n_edges - 1, 1))
    j = jax.random.randint(k_j, (), i + 2, jnp.maximum(n_edges + 1, i + 3))
    j = jnp.minimum(j, n_edges)

    x_i = nodes[i, : system.state_dim]
    controls = system.control_spec.sample(k_ctrl, (K,))
    x_c, valid_c = rollout_batch(
        system, jnp.broadcast_to(x_i, (K, system.state_dim)), controls,
        cfg.num_disc, obstacles, cfg.width, cfg.height,
        footprint=cfg.footprint,
    )

    # replay suffix edges j+1..n_edges from each candidate end state
    m = n_edges - j  # number of suffix edges

    def replay_step(carry, t):
        state, ok = carry  # state [K, 4], ok [K]
        active = t < m
        ctrl = nodes[jnp.minimum(j + 1 + t, N - 1), system.state_dim:]
        x1, v = rollout_batch(
            system, state, jnp.broadcast_to(ctrl, (K, ctrl.shape[0])),
            cfg.num_disc, obstacles, cfg.width, cfg.height,
            footprint=cfg.footprint,
        )
        state = jnp.where(active, x1, state)
        ok = ok & (~active | v)
        return (state, ok), state

    (final_state, ok_suffix), suffix_states = jax.lax.scan(
        replay_step, (x_c, valid_c), jnp.arange(N, dtype=jnp.int32)
    )
    # suffix_states: [N, K, state_dim] (entries t >= m are frozen copies)

    d2 = ((final_state[:, 0] - goal_xy[0]) ** 2
          + (final_state[:, 1] - goal_xy[1]) ** 2)
    in_goal = d2 < cfg.goal_threshold**2
    feasible = valid_c & ok_suffix & in_goal & can

    # time gain: duration of replaced edges i+1..j minus the candidate's
    durations = nodes[:, SAMPLE_DIM - 1]
    edge_idx = jnp.arange(N)
    replaced = ((edge_idx >= i + 1) & (edge_idx <= j)).astype(jnp.float32)
    replaced_time = (durations * replaced).sum()
    gains = jnp.where(feasible, replaced_time - controls[:, -1], -jnp.inf)
    best = jnp.argmax(gains)
    accept = gains[best] > min_gain

    # splice: slot s keeps nodes[s] for s <= i; s == i+1 takes the candidate;
    # s in (i+1, i+1+m] takes replayed suffix edge t = s - i - 2
    cand_sample = jnp.concatenate([x_c[best], controls[best]])
    t_of_slot = edge_idx - (i + 2)  # suffix index per slot
    suffix_sample = jnp.concatenate(
        [
            suffix_states[jnp.clip(t_of_slot, 0, N - 1), best],
            nodes[jnp.clip(j + 1 + t_of_slot, 0, N - 1), system.state_dim:],
        ],
        axis=-1,
    )  # [N, SAMPLE_DIM]
    new_nodes = jnp.where(
        (edge_idx <= i)[:, None], nodes,
        jnp.where(
            (edge_idx == i + 1)[:, None], cand_sample[None, :],
            jnp.where(
                (t_of_slot >= 0)[:, None] & (t_of_slot < m)[:, None],
                suffix_sample, jnp.zeros_like(nodes),
            ),
        ),
    )
    new_n_edges = i + 1 + m
    nodes = jnp.where(accept, new_nodes, nodes)
    n_edges = jnp.where(accept, new_n_edges, n_edges)
    return nodes, n_edges


@partial(jax.jit, static_argnames=("system", "cfg", "K", "N", "rounds"))
def _shortcut_batch_jit(system, cfg: KGMTConfig, K: int, N: int, rounds: int,
                        nodes, n_edges, goal_xys, obstacles, key, min_gain):
    """All rounds x all paths in ONE program: lax.scan over rounds, vmap of
    ``_shortcut_round`` over the padded path batch."""
    B = nodes.shape[0]

    def round_step(carry, r):
        nd, ne = carry
        kr = jax.random.fold_in(key, r)
        keys = jax.vmap(lambda b: jax.random.fold_in(kr, b))(
            jnp.arange(B, dtype=jnp.int32))
        nd, ne = jax.vmap(
            lambda a, b_, g, ob, k_: _shortcut_round(
                system, cfg, K, N, a, b_, g, ob, k_, min_gain)
        )(nd, ne, goal_xys, obstacles, keys)
        return (nd, ne), None

    (nodes, n_edges), _ = jax.lax.scan(
        round_step, (nodes, n_edges), jnp.arange(rounds, dtype=jnp.int32))
    return nodes, n_edges


def shortcut_batch(system: System, cfg: KGMTConfig, paths: np.ndarray,
                   path_lengths: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, scfg: ShortcutConfig | None = None,
                   seed: int = 0) -> dict:
    """Shortcut a whole multi-query batch of solved paths in ONE jitted
    program (the post-processing pipeline's first stage; refine_batch is
    the second). paths: [B, Lmax, SAMPLE_DIM] padded, root first
    (MultiQueryResult.paths layout); path_lengths: [B] node counts (< 2 =
    unsolved, passed through untouched — the ``n_edges >= 2`` guard inside
    the round makes them unshortcuttable by construction); obstacles:
    [B, K, 4] or shared [K, 4].

    Returns dict of arrays: paths [B, Lmax, SAMPLE_DIM] (entries past the
    new edge count zeroed, like the single-path variant), path_lengths [B]
    (new node counts), cost_before/cost_after [B]."""
    scfg = scfg or ShortcutConfig()
    B, N = paths.shape[0], paths.shape[1]
    obstacles = np.asarray(obstacles)
    if obstacles.ndim == 2:
        obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
    nodes0 = jnp.asarray(paths)
    n_edges0 = jnp.maximum(jnp.asarray(path_lengths, jnp.int32) - 1, 0)
    goal_xys = jnp.asarray(np.asarray(goals)[:, :2])
    nodes, n_edges = _shortcut_batch_jit(
        system, cfg, scfg.candidates, N, scfg.rounds, nodes0, n_edges0,
        goal_xys, jnp.asarray(obstacles), jax.random.key(seed),
        jnp.float32(scfg.min_gain))
    nodes = np.asarray(nodes)
    n_edges_np = np.asarray(n_edges)
    idx = np.arange(N)[None, :]
    edge_mask0 = (idx >= 1) & (idx <= np.asarray(n_edges0)[:, None])
    edge_mask1 = (idx >= 1) & (idx <= n_edges_np[:, None])
    return {
        "paths": nodes,
        "path_lengths": np.where(np.asarray(path_lengths) >= 2,
                                 n_edges_np + 1,
                                 np.asarray(path_lengths)),
        "cost_before": (np.asarray(paths)[:, :, SAMPLE_DIM - 1]
                        * edge_mask0).sum(axis=1),
        "cost_after": (nodes[:, :, SAMPLE_DIM - 1] * edge_mask1).sum(axis=1),
    }


def shortcut_path(system: System, cfg: KGMTConfig, path: np.ndarray,
                  goal: np.ndarray, obstacles: np.ndarray,
                  scfg: ShortcutConfig | None = None, seed: int = 0) -> dict:
    """Shortcut a solved path. path [L+1, SAMPLE_DIM] (root first, from
    KGMTResult.path). Returns dict with the new path, cost before/after."""
    scfg = scfg or ShortcutConfig()
    N = path.shape[0]
    if N < 2:
        raise ValueError("path must contain at least one edge")
    nodes = jnp.asarray(path)
    n_edges = jnp.asarray(N - 1, jnp.int32)
    goal_xy = jnp.asarray(goal[:2])
    obstacles_j = jnp.asarray(obstacles)
    key = jax.random.key(seed)
    for r in range(scfg.rounds):
        nodes, n_edges = _shortcut_round(
            system, cfg, scfg.candidates, N, nodes, n_edges, goal_xy,
            obstacles_j, jax.random.fold_in(key, r),
            jnp.float32(scfg.min_gain),
        )
    n = int(n_edges)
    new_path = np.asarray(nodes)[: n + 1]
    return {
        "path": new_path,
        "n_edges": n,
        "cost_before": float(path[1:, SAMPLE_DIM - 1].sum()),
        "cost_after": float(new_path[1:, SAMPLE_DIM - 1].sum()),
    }
