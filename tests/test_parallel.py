"""Distributed-mode tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4:
the answer to 'fake backends').

Covers BASELINE.json configs 4 (multi-query batch sharded over one host) and
the sharded-tree mode with psum'd region statistics, plus Monte-Carlo scenario
generation."""

import jax
import numpy as np
import pytest

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.parallel.mesh import device_count, make_planner_mesh
from cudasbmp_jax.parallel.monte_carlo import MonteCarloPlanner, random_scenarios
from cudasbmp_jax.parallel.multi_query import MultiQueryPlanner
from cudasbmp_jax.parallel.sharded_tree import ShardedTreePlanner
from cudasbmp_jax.geometry.aabb import point_in_any_obstacle


MQ_CONFIG = KGMTConfig(
    num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048
)


def test_mesh_shapes():
    assert device_count() == 8
    mesh = make_planner_mesh()
    assert mesh.shape == {"scenario": 8, "tree": 1}
    mesh = make_planner_mesh(n_scenario=2, n_tree=4)
    assert mesh.shape == {"scenario": 2, "tree": 4}
    with pytest.raises(ValueError):
        make_planner_mesh(n_scenario=3, n_tree=3)


@pytest.mark.slow
def test_multi_query_batch_sharded():
    """16 problems over 8 devices; all demo-like problems must solve and each
    path must end near its own goal."""
    mesh = make_planner_mesh()
    planner = MultiQueryPlanner(MQ_CONFIG, mesh=mesh)
    B = 16
    base = Scenario.demo()
    rng = np.random.default_rng(0)
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    # vary the goals a little (all in free space near (2,18))
    goals[:, 0] = rng.uniform(1.0, 3.0, B)
    goals[:, 1] = rng.uniform(16.5, 18.5, B)
    obstacles, _ = base.padded_obstacles(MQ_CONFIG.max_obstacles)
    res = planner.plan_batch(inits, goals, obstacles, seed=3)
    assert res.solved.mean() > 0.8, res.costs
    for b in range(B):
        if not res.solved[b]:
            continue
        L = res.path_lengths[b]
        end = res.paths[b, L - 1]
        d = np.hypot(end[0] - goals[b, 0], end[1] - goals[b, 1])
        assert d < MQ_CONFIG.goal_threshold


@pytest.mark.slow
def test_multi_query_with_footprint():
    """The narrow-phase footprint composes with the vmapped/sharded
    multi-query path (it is static config, so vmap just broadcasts it)."""
    cfg = MQ_CONFIG.replace(footprint_width=0.5)
    planner = MultiQueryPlanner(cfg, mesh=make_planner_mesh())
    B = 8
    base = Scenario.demo()
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
    res = planner.plan_batch(inits, goals, obstacles, seed=3)
    assert res.solved.mean() > 0.8, res.costs


@pytest.mark.slow
def test_multi_query_matches_unsharded():
    """Sharding is semantics-preserving: same batch on mesh vs no mesh."""
    base = Scenario.demo()
    B = 8
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    obstacles, _ = base.padded_obstacles(MQ_CONFIG.max_obstacles)
    r_mesh = MultiQueryPlanner(MQ_CONFIG, mesh=make_planner_mesh()).plan_batch(
        inits, goals, obstacles, seed=5
    )
    r_plain = MultiQueryPlanner(MQ_CONFIG, mesh=None).plan_batch(
        inits, goals, obstacles, seed=5
    )
    np.testing.assert_array_equal(r_mesh.solved, r_plain.solved)
    np.testing.assert_allclose(r_mesh.costs, r_plain.costs, rtol=1e-6)
    np.testing.assert_array_equal(r_mesh.tree_sizes, r_plain.tree_sizes)


@pytest.mark.slow
def test_sharded_tree_solves_and_uses_global_stats():
    mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    # adaptive_waves off: full fan-out fills these deliberately tiny 2048-slot
    # shards in ~5 generations, too shallow to reach the goal
    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    planner = ShardedTreePlanner(cfg, mesh=mesh)
    res = planner.plan(Scenario.demo())
    assert res.solved
    assert res.cost > 0
    # logical capacity is 8 * 2048; each shard grew something
    assert res.total_tree_size > 8
    assert res.path.shape[1] == 7
    # end of best path is in the goal region
    d = np.hypot(res.path[-1, 0] - 2.0, res.path[-1, 1] - 18.0)
    assert d < cfg.goal_threshold
    # the collective guidance loop: every shard scores regions from the SAME
    # psum'd global statistics, so all per-shard score vectors are identical
    scores = res.r1_scores_by_shard
    assert scores.shape[0] == 8
    for i in range(1, 8):
        np.testing.assert_array_equal(scores[0], scores[i])
    # and the scores reflect MORE than one shard's local view: global totals
    # summed over shards exceed any single shard's budget
    assert res.total_tree_size > cfg.max_tree_size // 2


@pytest.mark.slow
def test_sharded_tree_deterministic():
    mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    cfg = KGMTConfig(num_iterations=40, max_tree_size=1024,
                     rollouts_per_iter=256, adaptive_waves=False)
    r1 = ShardedTreePlanner(cfg, mesh=mesh).plan(Scenario.demo())
    r2 = ShardedTreePlanner(cfg, mesh=mesh).plan(Scenario.demo())
    assert r1.cost == r2.cost
    assert r1.best_shard == r2.best_shard
    np.testing.assert_array_equal(r1.path, r2.path)


@pytest.mark.slow
def test_sharded_tree_path_crosses_shards():
    """The stitched path is a real parent chain of ONE logical tree: it ends
    in the goal region, starts at the root, costs accumulate, and (with the
    frontier exchange on by default) paths are ALLOWED to cross shards —
    path_shards records the owner of every node."""
    mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    res = ShardedTreePlanner(cfg, mesh=mesh).plan(Scenario.demo())
    assert res.solved
    assert res.path_shards.shape[0] == res.path.shape[0]
    # root of the stitched chain is the scenario init
    np.testing.assert_allclose(res.path[0, :2], [5.0, 5.0])
    d = np.hypot(res.path[-1, 0] - 2.0, res.path[-1, 1] - 18.0)
    assert d < cfg.goal_threshold
    # stitched costs: edge durations along the chain sum to the solution cost
    assert abs(res.path[1:, 6].sum() - res.cost) < 1e-3
    # the goal node's owner is reported as best_shard
    assert res.path_shards[-1] == res.best_shard


@pytest.mark.slow
def test_sharded_tree_sterile_shard_rescued_by_exchange():
    """Forced-sterile-shard witness (SURVEY.md P7): one
    shard's root is seeded INSIDE an obstacle, so every rollout from its own
    frontier is invalid forever. Without frontier exchange that shard's tree
    is stuck at size 1; with the exchange it imports foreign frontier nodes
    and grows, while the collective still solves."""
    mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    base = Scenario.demo()
    trap = np.array([[14.0, 14.0, 16.0, 16.0]], np.float32)
    sc = Scenario(init=base.init, goal=base.goal,
                  obstacles=np.concatenate([base.obstacles, trap]))
    inits = np.tile(base.init, (8, 1)).astype(np.float32)
    inits[1, 0], inits[1, 1] = 15.0, 15.0  # inside the trap obstacle
    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)

    with_ex = ShardedTreePlanner(cfg, mesh=mesh).plan(sc, inits=inits)
    assert with_ex.solved
    assert with_ex.tree_sizes_by_shard[1] > 1, (
        "sterile shard must grow by expanding foreign frontier nodes")

    no_ex = ShardedTreePlanner(
        cfg.replace(exchange_frac=0.0), mesh=mesh
    ).plan(sc, inits=inits)
    assert no_ex.tree_sizes_by_shard[1] == 1, (
        "without exchange the walled-in shard can never grow")


def test_random_scenarios_valid():
    cfg = KGMTConfig()
    inits, goals, obstacles = random_scenarios(
        jax.random.key(0), 16, cfg, num_obstacles=6
    )
    assert inits.shape == (16, 7) and goals.shape == (16, 7)
    # tight-padded to a multiple of 8 (the collision loop is O(padded rows),
    # Scenario.padded_obstacles), not to the config max of 32
    assert obstacles.shape == (16, 8, 4)
    import jax.numpy as jnp

    for b in range(16):
        # starts/goals inside workspace and outside obstacles
        for p in (inits[b, :2], goals[b, :2]):
            assert (p > 0).all() and (p < 20.0).all()
            assert not bool(point_in_any_obstacle(jnp.asarray(p),
                                                  jnp.asarray(obstacles[b])))
        # real obstacle boxes are non-degenerate, padding is degenerate
        real = obstacles[b, :6]
        assert (real[:, 2:] >= real[:, :2]).all()
    # deterministic
    i2, g2, o2 = random_scenarios(jax.random.key(0), 16, cfg, num_obstacles=6)
    np.testing.assert_array_equal(inits, i2)


@pytest.mark.slow
def test_monte_carlo_sweep():
    cfg = KGMTConfig(num_iterations=40, max_tree_size=4096,
                     rollouts_per_iter=512)
    mc = MonteCarloPlanner(cfg, mesh=make_planner_mesh())
    summary = mc.run(num_scenarios=16, seed=0, num_obstacles=5)
    assert summary.num_scenarios == 16
    assert 0.0 <= summary.solve_rate <= 1.0
    assert summary.solve_rate > 0.4  # sparse obstacles: most should solve
    assert summary.solves_per_sec > 0


@pytest.mark.slow
def test_sharded_plan_checkpointed_matches_plan_and_resumes(tmp_path):
    """Elastic recovery for the DISTRIBUTED mode (SURVEY.md §5): chunked
    execution with periodic full-state checkpoints is bit-identical to the
    one-shot solve, and resuming from an intermediate checkpoint reproduces
    the exact final result (the 2-process kill-and-restart variant lives in
    tests/test_multihost.py)."""
    mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    st = ShardedTreePlanner(cfg, mesh=mesh)
    ref = st.plan(Scenario.demo())
    assert ref.solved

    r = st.plan_checkpointed(Scenario.demo(), tmp_path, checkpoint_every=3,
                             seed=None)
    assert r.solved and r.cost == ref.cost
    np.testing.assert_array_equal(r.path, ref.path)
    ckpts = sorted(tmp_path.glob("sharded_checkpoint_*.npz"),
                   key=lambda p: int(p.stem.split("_")[-1]))
    assert len(ckpts) >= 2, "expected several chunk checkpoints"

    # resume from the EARLIEST checkpoint: same final cost and path
    r2 = st.plan_checkpointed(Scenario.demo(), tmp_path / "resumed",
                              checkpoint_every=3, resume_from=ckpts[0])
    assert r2.solved and r2.cost == ref.cost
    np.testing.assert_array_equal(r2.path, ref.path)

    # resuming on a mesh with a different tree-axis size must refuse loudly
    # (silent resharding would truncate shards)
    bad = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_scenario=2,
                                                         n_tree=4))
    with pytest.raises(ValueError, match="tree shards"):
        bad.plan_checkpointed(Scenario.demo(), tmp_path / "bad",
                              resume_from=ckpts[0])


@pytest.mark.slow
def test_sharded_multi_query_batch_of_sharded_trees():
    """BASELINE config 5 in full: a problem BATCH over the scenario axis,
    each problem one collective sharded tree over the tree axis (psum'd
    guidance + frontier exchange inside each problem, nothing between
    problems). 4 problems x 2-shard trees on the 8-device mesh."""
    from cudasbmp_jax.parallel.sharded_multi_query import (
        ShardedMultiQueryPlanner,
    )

    mesh = make_planner_mesh(n_scenario=4, n_tree=2)
    cfg = KGMTConfig(num_iterations=60, max_tree_size=8192,
                     rollouts_per_iter=1024, adaptive_waves=False)
    planner = ShardedMultiQueryPlanner(cfg, mesh=mesh)
    base = Scenario.demo()
    B = 4
    rng = np.random.default_rng(0)
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    goals[:, 0] = rng.uniform(1.0, 3.0, B)
    goals[:, 1] = rng.uniform(16.5, 18.5, B)
    obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
    res = planner.plan_batch(inits, goals, obstacles, seed=3)
    assert res.solved.all(), res.costs
    for b in range(B):
        path = res.paths[b]
        # stitched chain: root at init, end in THIS problem's goal region
        np.testing.assert_allclose(path[0, :2], [5.0, 5.0])
        d = np.hypot(path[-1, 0] - goals[b, 0], path[-1, 1] - goals[b, 1])
        assert d < cfg.goal_threshold
        # edge durations along the chain sum to the reported cost
        assert abs(path[1:, 6].sum() - res.costs[b]) < 1e-3
        assert res.path_shards[b].shape[0] == path.shape[0]
        # logical capacity spans both shards
        assert res.total_tree_sizes[b] > 1
    # different problems get different RNG streams -> different trees
    assert len({int(t) for t in res.total_tree_sizes}) > 1 or \
        len({float(c) for c in res.costs}) > 1


@pytest.mark.slow
def test_sharded_multi_query_deterministic():
    from cudasbmp_jax.parallel.sharded_multi_query import (
        ShardedMultiQueryPlanner,
    )

    mesh = make_planner_mesh(n_scenario=2, n_tree=4)
    cfg = KGMTConfig(num_iterations=40, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    base = Scenario.demo()
    inits = np.tile(base.init, (2, 1)).astype(np.float32)
    goals = np.tile(base.goal, (2, 1)).astype(np.float32)
    obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
    r1 = ShardedMultiQueryPlanner(cfg, mesh=mesh).plan_batch(
        inits, goals, obstacles, seed=9)
    r2 = ShardedMultiQueryPlanner(cfg, mesh=mesh).plan_batch(
        inits, goals, obstacles, seed=9)
    np.testing.assert_array_equal(r1.costs, r2.costs)
    for b in range(2):
        np.testing.assert_array_equal(r1.paths[b], r2.paths[b])


@pytest.mark.slow
def test_sharded_tree_honors_stop_on_first_solution_flag():
    """Anytime mode (stop_on_first_solution=False) must run the FULL budget
    in sharded mode too — an earlier version stopped the collective loop at
    the first solution regardless, silently truncating anytime solves and
    skewing fixed-work benchmarks (code-review r2 finding)."""
    mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    cfg = KGMTConfig(num_iterations=20, max_tree_size=8192,
                     rollouts_per_iter=1024, adaptive_waves=False,
                     stop_on_first_solution=False)
    r = ShardedTreePlanner(cfg, mesh=mesh).plan(Scenario.demo())
    assert r.iterations == 20, "anytime mode truncated early"
    r2 = ShardedTreePlanner(
        cfg.replace(stop_on_first_solution=True), mesh=mesh
    ).plan(Scenario.demo())
    assert r2.solved and r2.iterations < 20
