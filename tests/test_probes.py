"""Throughput-probe planner tests (NaivePlanner / CostPropPlanner analogs —
the reference's only 'benchmark harness', SURVEY.md §3.3)."""

import numpy as np

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.planners.costprop import CostPropPlanner
from cudasbmp_jax.planners.naive import NaivePlanner


def test_naive_tree_shape_and_ranges(demo_scenario):
    p = NaivePlanner(KGMTConfig(), width_rollouts=256, rows=4)
    r = p.plan(demo_scenario)
    assert r.samples.shape == (4, 256, 7)
    assert r.num_rollouts == 1024
    assert r.rollouts_per_sec > 0
    # probe control ranges (NaivePlanner.cu:31-35)
    a, steer, dur = r.samples[..., 4], r.samples[..., 5], r.samples[..., 6]
    assert a.min() >= -2.5 and a.max() <= 2.5
    assert steer.min() >= -np.pi / 2 and steer.max() <= np.pi / 2
    assert dur.min() >= 0.0 and dur.max() <= 0.3


def test_naive_rows_start_from_root(demo_scenario):
    """Every row propagates from the root (the reference *intended* this;
    its parent read is out-of-bounds, SURVEY.md §2.4.8)."""
    p = NaivePlanner(KGMTConfig(), width_rollouts=64, rows=3)
    r = p.plan(demo_scenario)
    # with duration <= 0.3 and v0 = 0, displacement from root is small
    d = np.hypot(r.samples[..., 0] - 5.0, r.samples[..., 1] - 5.0)
    assert d.max() < 1.0


def test_costprop_chains_rows(demo_scenario):
    p = CostPropPlanner(KGMTConfig(), width_rollouts=128, rows=5, group_size=32)
    r = p.plan(demo_scenario)
    assert r.samples.shape == (5, 128, 7)
    # group members share their leader's start state: same leader, same row ->
    # displacement continuity. Weak check: rows drift further from root.
    d = np.hypot(r.samples[..., 0] - 5.0, r.samples[..., 1] - 5.0)
    assert d[-1].mean() >= d[0].mean()


def test_costprop_reference_scale_runs(demo_scenario):
    """The 524,288-rollout probe shape (CostPropPlanner.cu:85-88), scaled by
    16 for CPU test time."""
    p = CostPropPlanner(KGMTConfig(), width_rollouts=32768, rows=1)
    r = p.plan(demo_scenario)
    assert r.num_rollouts == 32768
    assert np.isfinite(r.samples).all()
