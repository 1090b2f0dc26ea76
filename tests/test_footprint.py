"""Narrow-phase footprint collision tests (geometry/footprint.py — the
beyond-reference capability realizing the reference Agent's never-consulted
rectangular body, Agent.h:6-26 / SURVEY.md §2.1 'Agent model')."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.geometry.footprint import footprint_clear, footprint_corners
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.ops.rollout_pallas import rollout_pallas
from cudasbmp_jax.planners.kgmt import KGMT
from cudasbmp_jax.systems import KinematicBicycle, Point2D


def clear1(x, y, theta, hl, hw, boxes):
    return bool(
        footprint_clear(jnp.asarray([x], jnp.float32),
                        jnp.asarray([y], jnp.float32),
                        jnp.asarray([theta], jnp.float32),
                        hl, hw, jnp.asarray(boxes, jnp.float32))[0]
    )


def test_axis_aligned_reduces_to_aabb():
    """theta=0: body spans [x, x+2*hl] x [y-hw, y+hw]."""
    hl, hw = 0.5, 0.25  # body 1.0 x 0.5
    box = [[2.0, 2.0, 3.0, 3.0]]
    assert clear1(0.5, 2.5, 0.0, hl, hw, box)  # body ends at x=1.5
    assert not clear1(1.5, 2.5, 0.0, hl, hw, box)  # reaches x=2.5
    assert not clear1(2.5, 1.9, 0.0, hl, hw, box)  # y in [1.65, 2.15]
    assert clear1(2.5, 1.7, 0.0, hl, hw, box)  # y in [1.45, 1.95]
    # touching does NOT collide (matches broad-phase <= convention)
    assert clear1(1.0, 2.5, 0.0, hl, hw, box)  # front edge exactly at x=2
    assert clear1(2.5, 1.75, 0.0, hl, hw, box)  # top edge exactly at y=2


def test_rotated_quarter_turn():
    """theta=pi/2: body spans [x-hw, x+hw] x [y, y+2*hl]."""
    hl, hw = 0.5, 0.25
    box = [[2.0, 2.0, 3.0, 3.0]]
    assert not clear1(2.5, 1.5, math.pi / 2, hl, hw, box)  # reaches y=2.5
    assert clear1(2.5, 0.5, math.pi / 2, hl, hw, box)  # ends at y=1.5
    assert clear1(1.5, 2.5, math.pi / 2, hl, hw, box)  # x in [1.25, 1.75]


def test_diagonal_narrow_phase_beats_broad_phase():
    """A 45-degree body whose AABB overlaps the box but whose OBB does not:
    the SAT axes must separate it."""
    hl, hw = 1.0, 0.05  # long thin body
    theta = math.pi / 4
    # body from (0,0) toward (sqrt2, sqrt2); box tucked in the corner beside
    # the diagonal — inside the body's AABB, outside the body
    box = [[1.0, 0.0, 1.4, 0.4]]
    assert clear1(0.0, 0.0, theta, hl, hw, box)
    # same box moved onto the diagonal does collide
    box2 = [[0.6, 0.6, 1.0, 1.0]]
    assert not clear1(0.0, 0.0, theta, hl, hw, box2)


def test_zero_thickness_wall_still_hits():
    """A zero-width wall (xmin == xmax) is solid to the broad phase, so the
    narrow phase must not mask it out (only padding rows, max < min, are
    excluded). Regression: the valid-box cut must be >= 0, not > 0."""
    wall = [[3.0, 1.0, 3.0, 5.0]]
    # body parallel to the wall, straddling it
    assert not clear1(2.6, 3.0, 0.0, 0.5, 0.25, wall)  # spans x in [2.6, 3.6]
    assert clear1(1.0, 3.0, 0.0, 0.5, 0.25, wall)  # ends at x=2
    # body crossing the wall at 90 degrees
    assert not clear1(3.2, 2.0, math.pi, 0.5, 0.25, wall)


def test_degenerate_padding_boxes_never_hit():
    pad = np.zeros((4, 4), np.float32)
    pad[:, 0:2] = 1.0  # min = 1, max = 0 (Scenario.padded_obstacles)
    for theta in (0.0, 0.3, 2.0):
        assert clear1(0.5, 0.5, theta, 5.0, 5.0, pad)


def test_randomized_against_point_sampling(rng):
    """SAT verdicts agree with dense point-sampling of both shapes on
    non-marginal cases."""
    hl, hw = 0.6, 0.2
    # footprint interior sample grid in the agent frame (rear axle origin)
    gx, gy = np.meshgrid(np.linspace(0.01, 2 * hl - 0.01, 40),
                         np.linspace(-hw + 0.01, hw - 0.01, 16))
    disagreements = 0
    checked = 0
    for _ in range(300):
        x, y = rng.uniform(0, 4, 2)
        theta = rng.uniform(-math.pi, math.pi)
        bx, by = rng.uniform(0, 4, 2)
        bw, bh = rng.uniform(0.2, 1.5, 2)
        box = np.array([[bx, by, bx + bw, by + bh]], np.float32)
        got_clear = clear1(x, y, theta, hl, hw, box)

        ct, st = math.cos(theta), math.sin(theta)
        wx = x + gx * ct - gy * st
        wy = y + gx * st + gy * ct
        fp_pts_in_box = np.any((wx > bx) & (wx < bx + bw)
                               & (wy > by) & (wy < by + bh))
        # box interior points mapped into the agent frame
        bgx, bgy = np.meshgrid(np.linspace(bx + 0.01, bx + bw - 0.01, 24),
                               np.linspace(by + 0.01, by + bh - 0.01, 24))
        lx = (bgx - x) * ct + (bgy - y) * st
        ly = -(bgx - x) * st + (bgy - y) * ct
        box_pts_in_fp = np.any((lx > 0) & (lx < 2 * hl)
                               & (np.abs(ly) < hw))
        sampled_hit = bool(fp_pts_in_box or box_pts_in_fp)
        # point sampling misses slivers; only compare when the sampled
        # verdict is unambiguous (hit) or the shapes are well separated
        corners = np.asarray(footprint_corners(
            jnp.float32(x), jnp.float32(y), jnp.float32(theta), hl, hw))
        d_margin = max(
            bx - corners[:, 0].max(), corners[:, 0].min() - (bx + bw),
            by - corners[:, 1].max(), corners[:, 1].min() - (by + bh),
        )
        if sampled_hit:
            checked += 1
            disagreements += int(got_clear)
        elif d_margin > 0.05:  # clearly separated even along world axes
            checked += 1
            disagreements += int(not got_clear)
    assert checked > 100
    assert disagreements == 0


def test_rollout_footprint_blocks_side_passage():
    """A point path that clears the broad phase but whose body clips an
    obstacle beside it: valid without footprint, invalid with."""
    system = Point2D()
    x0 = jnp.asarray([[2.0, 1.0, 0.0, 0.0]], jnp.float32)
    controls = jnp.asarray([[2.0, 0.0, 1.0]], jnp.float32)  # +x, 1 s
    # obstacle above the path: y in [1.3, 3] — the center segment at y=1
    # never touches it
    obstacles = jnp.asarray([[2.5, 1.3, 3.5, 3.0]], jnp.float32)
    _, valid_point = rollout_batch(system, x0, controls, 10, obstacles,
                                   20.0, 20.0)
    assert bool(valid_point[0])
    # body 1.0 wide (hw 0.5) reaches y=1.5 > 1.3 (point2d has no heading ->
    # axis-aligned body)
    _, valid_body = rollout_batch(system, x0, controls, 10, obstacles,
                                  20.0, 20.0, footprint=(0.5, 0.5))
    assert not bool(valid_body[0])


def test_pallas_footprint_parity(rng):
    """Fused-kernel footprint math is bitwise-identical to the jnp path."""
    system = KinematicBicycle()
    B = 512
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, B)
    x0[:, 1] = rng.uniform(0.5, 19.5, B)
    x0[:, 2] = rng.uniform(-math.pi, math.pi, B)
    x0[:, 3] = rng.uniform(-3, 3, B)
    spec = system.control_spec
    u = rng.uniform(0, 1, (B, spec.dim)).astype(np.float32)
    controls = (np.asarray(spec.lo) + u * (np.asarray(spec.hi)
                                           - np.asarray(spec.lo))
                ).astype(np.float32)
    fp = (0.5, 0.25)
    x1_ref, valid_ref = rollout_batch(
        system, jnp.asarray(x0), jnp.asarray(controls), 10, obstacles,
        20.0, 20.0, footprint=fp,
    )
    x1_pl, valid_pl = rollout_pallas(
        system, jnp.asarray(x0), jnp.asarray(controls), obstacles,
        num_disc=10, width=20.0, height=20.0, interpret=True, footprint=fp,
    )
    # footprint must actually reject some rollouts the broad phase passes
    _, valid_nofp = rollout_batch(
        system, jnp.asarray(x0), jnp.asarray(controls), 10, obstacles,
        20.0, 20.0,
    )
    assert int(valid_nofp.sum()) > int(valid_ref.sum())
    np.testing.assert_array_equal(np.array(valid_ref), np.array(valid_pl))
    np.testing.assert_allclose(np.array(x1_ref), np.array(x1_pl),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_planner_solves_with_footprint(small_config):
    """End-to-end: the planner solves the demo scenario with a real body, and
    every pose along the re-integrated path keeps the body collision-free."""
    cfg = small_config.replace(footprint_width=0.5)
    result = KGMT(cfg).plan(Scenario.demo())
    assert result.solved
    obstacles, _ = Scenario.demo().padded_obstacles(cfg.max_obstacles)
    obstacles = jnp.asarray(obstacles)
    hl, hw = cfg.footprint
    # re-integrate each edge at the planner's own resolution: the guarantee
    # is footprint clearance at every num_disc post-step pose (like the
    # reference, collision checking is discrete-time at num_disc steps)
    system = KinematicBicycle(agent_length=cfg.agent_length)
    p = result.path
    for i in range(1, len(p)):
        state = jnp.asarray(p[i - 1][:4])
        ctrl = jnp.asarray(p[i][4:6])
        dt = p[i][6] / cfg.num_disc
        for _ in range(cfg.num_disc):
            state = system.step(state, ctrl, dt)
            assert bool(footprint_clear(state[0], state[1], state[2],
                                        hl, hw, obstacles))


def test_config_footprint_validation():
    with pytest.raises(ValueError):
        KGMTConfig(footprint_width=-0.1)
    assert KGMTConfig().footprint is None
    assert KGMTConfig(footprint_width=0.5, agent_length=1.0).footprint == (
        0.5, 0.25)
