"""Kinodynamic shortcutting tests: cost must not increase, the spliced path
must replay collision-free into the goal region."""

import jax.numpy as jnp
import numpy as np
import pytest

from cudasbmp_jax.config import Scenario
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.planners.kgmt import KGMT
from cudasbmp_jax.shortcut import ShortcutConfig, shortcut_path


@pytest.mark.slow
def test_shortcut_improves_and_stays_valid(small_config, demo_scenario):
    planner = KGMT(small_config)
    result = planner.plan(demo_scenario)
    assert result.solved
    out = shortcut_path(
        planner.system, small_config, result.path, demo_scenario.goal,
        demo_scenario.obstacles, ShortcutConfig(rounds=48, candidates=128),
    )
    assert out["cost_after"] <= out["cost_before"] + 1e-5
    assert out["n_edges"] <= len(result.path) - 1
    # hard replay of the shortcut path
    path = out["path"]
    state = jnp.asarray(path[0][:4])[None]
    obstacles = jnp.asarray(demo_scenario.obstacles)
    for k in range(1, len(path)):
        state, valid = rollout_batch(
            planner.system, state, jnp.asarray(path[k][4:])[None],
            small_config.num_disc, obstacles, 20.0, 20.0,
        )
        assert bool(valid[0]), f"shortcut edge {k} invalid on replay"
    end = np.asarray(state[0])
    d = np.hypot(end[0] - demo_scenario.goal[0], end[1] - demo_scenario.goal[1])
    assert d < small_config.goal_threshold
    # stored node states must equal the replayed states (replay invariant)
    np.testing.assert_allclose(end, path[-1][:4], rtol=1e-4, atol=1e-4)


def test_shortcut_rejects_trivial_path(small_config, demo_scenario):
    planner = KGMT(small_config)
    with pytest.raises(ValueError):
        shortcut_path(planner.system, small_config,
                      np.zeros((1, 7), np.float32), demo_scenario.goal,
                      demo_scenario.obstacles)


@pytest.mark.slow
def test_shortcut_generic_over_systems(small_config, demo_scenario):
    """The suffix replay broadcasts the stored control at the system's own
    control dimension (regression for a hardcoded 3)."""
    # narrower wave: point2d needs ~41 iterations; at 2048/iter the tree
    # fills before the goal is reached
    cfg = small_config.replace(system="point2d", rollouts_per_iter=1024)
    planner = KGMT(cfg)
    result = planner.plan(demo_scenario)
    assert result.solved
    out = shortcut_path(planner.system, cfg, result.path,
                        demo_scenario.goal, demo_scenario.obstacles,
                        ShortcutConfig(rounds=16, candidates=64))
    assert out["cost_after"] <= out["cost_before"] + 1e-5


@pytest.mark.slow
def test_shortcut_batch_multi_query(small_config, demo_scenario):
    """shortcut_batch: the whole multi-query batch shortcuts in one jitted
    program; every solved row's cost must not increase and its new path
    must replay collision-free into the goal region. Unsolved rows pass
    through untouched."""
    from cudasbmp_jax.parallel.batch_kgmt import ArenaMultiQueryPlanner
    from cudasbmp_jax.shortcut import shortcut_batch

    cfg = small_config.replace(rollouts_per_iter=128, num_iterations=60,
                               adaptive_waves=False)
    planner = ArenaMultiQueryPlanner(cfg, auto_capacity=True)
    B = 8
    inits = np.tile(demo_scenario.init, (B, 1))
    goals = np.tile(demo_scenario.goal, (B, 1))
    obstacles, _ = demo_scenario.padded_obstacles(cfg.max_obstacles)
    res = planner.plan_batch(inits, goals, obstacles, seed=2)
    assert res.solved.any()
    out = shortcut_batch(planner.system, cfg, res.paths, res.path_lengths,
                         goals, obstacles,
                         ShortcutConfig(rounds=24, candidates=64), seed=5)
    solved = res.path_lengths >= 2
    assert (out["cost_after"][solved] <= out["cost_before"][solved] + 1e-5
            ).all()
    np.testing.assert_array_equal(out["path_lengths"][~solved],
                                  res.path_lengths[~solved])
    assert (out["path_lengths"][solved] <= res.path_lengths[solved]).all()
    # hard replay of every solved shortcut path
    for b in np.flatnonzero(solved):
        path = out["paths"][b][: out["path_lengths"][b]]
        state = jnp.asarray(path[0][:4])[None]
        obs = jnp.asarray(obstacles)
        for k in range(1, len(path)):
            state, valid = rollout_batch(
                planner.system, state, jnp.asarray(path[k][4:])[None],
                cfg.num_disc, obs, 20.0, 20.0)
            assert bool(valid[0]), f"path {b} edge {k} invalid on replay"
        end = np.asarray(state[0])
        d = np.hypot(end[0] - demo_scenario.goal[0],
                     end[1] - demo_scenario.goal[1])
        assert d < cfg.goal_threshold
