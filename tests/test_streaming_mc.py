"""Streaming Monte-Carlo sweep (parallel/streaming_mc.py): slot refill,
per-scenario result integrity, determinism, and pool-size invariance."""

import jax
import numpy as np
import pytest

from cudasbmp_jax.config import KGMTConfig
from cudasbmp_jax.parallel.streaming_mc import StreamingMonteCarloPlanner

# small shapes keep the CPU suite quick; jnp backend (no GPU kernel)
CFG = KGMTConfig(rollouts_per_iter=256, num_iterations=40,
                 rollout_backend="jnp", adaptive_waves=False,
                 max_tree_size=2)  # unused by the streaming planner


def test_stream_more_scenarios_than_pool():
    """The pool refills until every scenario is processed exactly once."""
    mc = StreamingMonteCarloPlanner(CFG, pool=4)
    s = mc.run(num_scenarios=10, seed=0, num_obstacles=5)
    assert s.num_scenarios == 10
    assert s.costs.shape == (10,)
    # every scenario completed: either solved (finite cost) or exhausted its
    # budget with the full iteration count recorded
    assert ((np.isfinite(s.costs)) | (s.iters >= CFG.num_iterations)).all()
    assert s.solve_rate >= 0.5, s.costs
    assert (s.iters[np.isfinite(s.costs)] >= 1).all()
    assert s.num_budget_exhausted == int((~np.isfinite(s.costs)).sum())


def test_stream_deterministic():
    mc = StreamingMonteCarloPlanner(CFG, pool=4)
    a = mc.run(num_scenarios=8, seed=3, num_obstacles=5)
    b = mc.run(num_scenarios=8, seed=3, num_obstacles=5)
    assert (a.costs == b.costs).all()
    assert (a.iters == b.iters).all()


def test_stream_pool_smaller_equal_larger():
    """Both the scenario GENERATOR and the per-scenario search RNG are keyed
    by global scenario id (r5), so pool size is irrelevant to the results:
    different pool widths must produce BITWISE identical per-scenario
    (cost, iterations)."""
    small = StreamingMonteCarloPlanner(CFG, pool=2).run(
        num_scenarios=6, seed=1, num_obstacles=5)
    large = StreamingMonteCarloPlanner(CFG, pool=8).run(
        num_scenarios=6, seed=1, num_obstacles=5)
    assert small.costs.shape == large.costs.shape == (6,)
    np.testing.assert_array_equal(small.costs, large.costs)
    np.testing.assert_array_equal(small.iters, large.iters)
    solved = np.isfinite(small.costs)
    if solved.any():
        assert (small.costs[solved] > 0).all()
        assert (small.costs[solved] < 60.0).all()


def test_partitioned_pools_reproduce_single_pool():
    """N pools over disjoint scenario-id ranges
    (run(id_lo=...)) reproduce the unpartitioned sweep bit-for-bit — the
    deployment model for multi-chip streaming sweeps."""
    single = StreamingMonteCarloPlanner(CFG, pool=4).run(
        num_scenarios=12, seed=7, num_obstacles=5)
    mc = StreamingMonteCarloPlanner(CFG, pool=4)
    parts = [mc.run(num_scenarios=4, seed=7, num_obstacles=5, id_lo=lo)
             for lo in (0, 4, 8)]
    union_costs = np.concatenate([p.costs for p in parts])
    union_iters = np.concatenate([p.iters for p in parts])
    np.testing.assert_array_equal(union_costs, single.costs)
    np.testing.assert_array_equal(union_iters, single.iters)


def test_sharded_pools_reproduce_single_pool():
    """run_sharded: one pool per device along the 'scenario' axis of a
    4-device CPU mesh, concatenated by shard_map — bitwise equal to the
    single-pool sweep, with no collectives in the program."""
    mesh = jax.make_mesh((4,), ("scenario",))
    single = StreamingMonteCarloPlanner(CFG, pool=4).run(
        num_scenarios=8, seed=5, num_obstacles=5)
    sharded = StreamingMonteCarloPlanner(CFG, pool=4).run_sharded(
        num_scenarios=8, mesh=mesh, seed=5, num_obstacles=5)
    np.testing.assert_array_equal(sharded.costs, single.costs)
    np.testing.assert_array_equal(sharded.iters, single.iters)


def test_sharded_rejects_uneven_partition():
    mesh = jax.make_mesh((4,), ("scenario",))
    with pytest.raises(ValueError, match="divide evenly"):
        StreamingMonteCarloPlanner(CFG, pool=4).run_sharded(
            num_scenarios=6, mesh=mesh, seed=0, num_obstacles=5)


def test_stream_zero_budget():
    cfg = CFG.replace(num_iterations=0)
    mc = StreamingMonteCarloPlanner(cfg, pool=4)
    s = mc.run(num_scenarios=4, seed=0, num_obstacles=5)
    assert s.solve_rate == 0.0
    assert s.num_budget_exhausted == 4


def test_stream_matches_static_arena_quality():
    """Same scenario-generation recipe as the static Monte-Carlo sweep: the
    streaming planner's solve rate on an easy randomized set should be in
    the same band as MonteCarloPlanner(impl='arena')."""
    from cudasbmp_jax.parallel.monte_carlo import MonteCarloPlanner

    stream = StreamingMonteCarloPlanner(CFG, pool=8).run(
        num_scenarios=8, seed=5, num_obstacles=5)
    static = MonteCarloPlanner(CFG.replace(max_tree_size=256 * 41),
                               impl="arena").run(
        num_scenarios=8, seed=5, num_obstacles=5)
    assert abs(stream.solve_rate - static.solve_rate) <= 0.375, (
        stream.costs, static.costs)
