"""Differentiable trajectory-refinement tests: refined solutions must remain
hard-valid and should not be worse than the input."""

import numpy as np
import pytest

from cudasbmp_jax.config import Scenario
from cudasbmp_jax.planners.kgmt import KGMT
from cudasbmp_jax.refine import RefineConfig, refine_path


@pytest.mark.slow
def test_refine_demo_solution(small_config, demo_scenario):
    planner = KGMT(small_config)
    result = planner.plan(demo_scenario)
    assert result.solved
    out = refine_path(
        planner.system, small_config, result.path, demo_scenario.goal,
        demo_scenario.obstacles, RefineConfig(iterations=150),
    )
    assert np.isfinite(out["losses"]).all()
    # best-iterate tracking: the returned controls are never worse than the
    # input (chained-Euler gradients are chaotic; late iterates may diverge,
    # the refiner must fall back to the best seen)
    assert out["losses"].min() <= out["losses"][0] + 1e-5
    assert out["valid"], "best-iterate fallback must keep a valid trajectory"
    assert out["cost_after"] <= out["cost_before"] + 1e-5
    # refined controls stay inside the sampling box
    c = out["controls"]
    assert (c[:, 0] >= -5.0).all() and (c[:, 0] <= 5.0).all()
    assert (c[:, 2] >= 0.0).all() and (c[:, 2] <= 1.05).all()


def test_refine_rejects_too_short_path(small_config, demo_scenario):
    planner = KGMT(small_config)
    with pytest.raises(ValueError):
        refine_path(planner.system, small_config,
                    np.zeros((1, 7), np.float32), demo_scenario.goal,
                    demo_scenario.obstacles)


@pytest.mark.slow
def test_refine_batch_multi_query(small_config):
    """Whole-batch refinement: one jitted program refines
    a multi-query batch; every refined path must pass hard re-validation and
    never report a cost above its input."""
    from cudasbmp_jax.parallel.multi_query import MultiQueryPlanner
    from cudasbmp_jax.refine import refine_batch
    from cudasbmp_jax.systems.registry import get_system

    cfg = small_config
    sc = Scenario.demo()
    B = 4
    inits = np.tile(sc.init, (B, 1))
    goals = np.tile(sc.goal, (B, 1))
    goals[:, 0] += np.linspace(0.0, 1.5, B, dtype=np.float32)
    obstacles, _ = sc.padded_obstacles(cfg.max_obstacles)
    res = MultiQueryPlanner(cfg).plan_batch(inits, goals, obstacles, seed=3)
    assert res.solved.all()

    out = refine_batch(
        get_system(cfg.system), cfg, res.paths, res.path_lengths, goals,
        obstacles, RefineConfig(iterations=120),
    )
    assert out["valid"].shape == (B,)
    # cost can only be reported lower where the refiner kept a valid result;
    # 'improved' implies both
    imp = out["improved"]
    assert (out["cost_after"][imp] < out["cost_before"][imp] + 1e-6).all()
    assert (out["valid"] | ~imp).all()
    # at least one problem in an easy batch should actually improve
    assert imp.any(), "refinement should improve at least one demo path"
    # per-problem parity with the single-path API on problem 0
    from cudasbmp_jax.refine import refine_path

    L0 = int(res.path_lengths[0])
    single = refine_path(
        get_system(cfg.system), cfg, res.paths[0, :L0], goals[0], obstacles,
        RefineConfig(iterations=120),
    )
    np.testing.assert_allclose(
        single["controls"], out["controls"][0, : L0 - 1], rtol=1e-4,
        atol=1e-5,
    )


def test_refine_batch_skips_unsolved_rows():
    """Rows with path_length < 2 (unsolved) must come back valid=False,
    improved=False and leave their controls untouched."""
    from cudasbmp_jax.refine import refine_batch
    from cudasbmp_jax.systems.registry import get_system
    from cudasbmp_jax.config import KGMTConfig

    cfg = KGMTConfig()
    sc = Scenario.demo()
    obstacles, _ = sc.padded_obstacles(cfg.max_obstacles)
    paths = np.zeros((2, 5, 7), np.float32)
    paths[:, 0, :2] = [5.0, 5.0]
    lengths = np.array([0, 1])
    goals = np.tile(sc.goal, (2, 1))
    out = refine_batch(get_system(cfg.system), cfg, paths, lengths, goals,
                       obstacles, RefineConfig(iterations=5))
    assert not out["valid"].any()
    assert not out["improved"].any()
