"""Visualization smoke tests (MATLAB-script replacement, SURVEY.md §3.4)."""

from pathlib import Path

from cudasbmp_jax.planners.kgmt import KGMT
from cudasbmp_jax.io.csv import write_artifacts
from cudasbmp_jax.viz import plot_metrics, plot_tree


def test_plot_tree_from_result(small_config, demo_scenario, tmp_path):
    result = KGMT(small_config).plan(demo_scenario)
    out = plot_tree(result=result, config=small_config,
                    obstacles=demo_scenario.obstacles,
                    out_path=str(tmp_path / "tree.png"), max_edges=200)
    assert Path(out).stat().st_size > 10_000


def test_plot_tree_with_footprint_overlay(small_config, demo_scenario,
                                          tmp_path):
    cfg = small_config.replace(footprint_width=0.5)
    result = KGMT(cfg).plan(demo_scenario)
    out = plot_tree(result=result, config=cfg,
                    obstacles=demo_scenario.obstacles,
                    out_path=str(tmp_path / "tree_fp.png"), max_edges=200,
                    footprint=cfg.footprint)
    assert Path(out).stat().st_size > 10_000


def test_plot_tree_from_artifacts(small_config, demo_scenario, tmp_path):
    result = KGMT(small_config).plan(demo_scenario)
    write_artifacts(result.state, small_config, tmp_path)
    out = plot_tree(artifacts_dir=tmp_path, config=small_config,
                    out_path=str(tmp_path / "tree2.png"), max_edges=50)
    assert Path(out).exists()


def test_plot_metrics(small_config, demo_scenario, tmp_path):
    result = KGMT(small_config).plan(demo_scenario)
    out = plot_metrics(result.metrics, out_path=str(tmp_path / "m.png"))
    assert Path(out).stat().st_size > 5_000


def test_plot_steps_frames(tmp_path):
    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.viz import plot_steps

    cfg = KGMTConfig(num_iterations=6, max_tree_size=2048,
                     rollouts_per_iter=512)
    KGMT(cfg).plan_recorded(Scenario.demo(), tmp_path / "rec", dump_every=2)
    frames = plot_steps(tmp_path / "rec", config=cfg,
                        obstacles=Scenario.demo().obstacles,
                        out_dir=tmp_path / "frames", max_edges=50)
    assert len(frames) >= 1
    assert Path(frames[0]).exists()


def test_plot_sharded_path(tmp_path):
    """Shard-colored stitched-path rendering for sharded results."""
    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.parallel.mesh import make_planner_mesh
    from cudasbmp_jax.parallel.sharded_tree import ShardedTreePlanner
    from cudasbmp_jax.viz import plot_sharded_path

    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    res = ShardedTreePlanner(
        cfg, mesh=make_planner_mesh(n_scenario=1, n_tree=8)
    ).plan(Scenario.demo())
    assert res.solved
    out = plot_sharded_path(res, config=cfg,
                            obstacles=Scenario.demo().obstacles,
                            out_path=str(tmp_path / "sp.png"))
    assert (tmp_path / "sp.png").stat().st_size > 10_000


def test_batched_edge_integration_matches_single():
    """The vmapped whole-tree re-integration is the same
    math as the per-edge MATLAB-style replay."""
    import numpy as np

    from cudasbmp_jax.systems.registry import get_system
    from cudasbmp_jax.viz import _integrate_edge_states, _integrate_edges

    system = get_system("bicycle")
    rng = np.random.default_rng(0)
    E = 40
    x0s = rng.uniform(1, 19, (E, 7)).astype(np.float32)
    ctrl = np.stack([
        rng.uniform(-5, 5, E), rng.uniform(-3, 3, E),
        rng.uniform(0.05, 1.05, E),
    ], -1).astype(np.float32)
    batch = _integrate_edges(system, x0s, ctrl, 10)
    assert batch.shape == (E, 11, system.state_dim)
    for i in (0, 7, 39):
        one = _integrate_edge_states(system, x0s[i], ctrl[i], 10)
        # vmap changes f32 fusion order; 1e-5 relative is float-noise level
        # for these deliberately chaotic (high-|tan|) test trajectories
        np.testing.assert_allclose(batch[i], one, rtol=2e-5, atol=1e-4)


def test_plot_tree_uncapped_full_tree(small_config, demo_scenario, tmp_path):
    """max_edges=None renders every edge of the solved tree (the former
    per-edge host loop needed a 2000-edge cap)."""
    from pathlib import Path

    result = KGMT(small_config).plan(demo_scenario)
    out = plot_tree(result=result, config=small_config,
                    obstacles=demo_scenario.obstacles,
                    out_path=str(tmp_path / "tree_full.png"))
    assert Path(out).stat().st_size > 10_000
