"""Planner-state invariant validation — the design-time answer to the
reference's unsanitized data races (SURVEY.md §5 'race detection': the CUDA
atomics in KGMT.cu:392-410 are racy and unchecked; here races are designed
out via segment reductions, and this module makes the remaining structural
invariants machine-checkable).

Use after any solve (or inside tests) to assert the tree is well-formed.
"""

from __future__ import annotations

import numpy as np

from cudasbmp_jax.config import KGMTConfig
from cudasbmp_jax.planners.kgmt import KGMTState


class InvariantViolation(AssertionError):
    pass


def validate_state(state: KGMTState, cfg: KGMTConfig) -> dict:
    """Check structural invariants; returns a summary dict or raises
    InvariantViolation naming the broken invariant."""
    n = int(state.tree_size)
    M = cfg.max_tree_size
    parents = np.asarray(state.tree_parent)
    costs = np.asarray(state.costs)
    samples = np.asarray(state.tree_samples)
    frontier_lo = int(state.frontier_lo)

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise InvariantViolation(msg)

    check(1 <= n <= M, f"tree_size {n} outside [1, {M}]")
    # topological order: every non-root node's parent precedes it
    check((parents[0] == -1), "root parent must be -1")
    if n > 1:
        idx = np.arange(1, n)
        check((parents[1:n] >= 0).all(), "committed node with unset parent")
        check((parents[1:n] < idx).all(), "parent does not precede child")
        # cost recurrence: cost[child] = cost[parent] + duration(child)
        expect = costs[parents[1:n]] + samples[1:n, 6]
        check(np.allclose(costs[1:n], expect, rtol=1e-5, atol=1e-5),
              "cost[child] != cost[parent] + duration")
    # unused slots untouched
    check((parents[n:] == -1).all(), "parent set beyond tree_size")
    check(0 <= frontier_lo <= n, "frontier range outside tree")
    # committed samples inside the workspace (valid rollouts only are
    # committed; bounds are exclusive)
    xy = samples[1:n, :2]
    check((xy > 0).all() and (xy[:, 0] < cfg.width).all()
          and (xy[:, 1] < cfg.height).all(),
          "committed sample outside workspace")
    # region stats are exactly consistent: valid + invalid == total per R1
    # cell (the root seed increments both valid and total, kgmt.py
    # init_state; every wave adds touched to total and touched-valid to
    # invalid)
    r1t = np.asarray(state.r1_total)
    r1v = np.asarray(state.r1_valid)
    r1i = np.asarray(state.r1_invalid)
    check((r1v + r1i == r1t).all(), "R1 valid+invalid != total")
    check((np.asarray(state.r1_avail) <= 1).all()
          and (np.asarray(state.r1_avail) >= 0).all(), "R1Avail not boolean")
    # solution consistency
    cost_to_goal = float(state.cost_to_goal)
    goal_node = int(state.goal_node)
    if np.isfinite(cost_to_goal):
        check(0 <= goal_node < n, "goal_node outside tree")
        check(np.isclose(costs[goal_node], cost_to_goal, rtol=1e-6),
              "cost_to_goal != costs[goal_node]")
    else:
        check(goal_node == -1, "goal_node set while unsolved")
    return {
        "tree_size": n,
        "max_depth": _max_depth(parents, n),
        "solved": bool(np.isfinite(cost_to_goal)),
    }


def _max_depth(parents: np.ndarray, n: int) -> int:
    depth = np.zeros(n, np.int32)
    for i in range(1, n):
        depth[i] = depth[parents[i]] + 1
    return int(depth.max()) if n else 0
