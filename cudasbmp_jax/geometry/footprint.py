"""Narrow-phase collision: oriented rectangular footprint vs AABB obstacles.

Beyond-reference capability. The reference checks ONLY the motion segment's
point-swept AABB (collisionCheck.cu:16-28, "No narrow phase ever" — SURVEY.md
§2.1) even though its host ``Agent`` carries a rectangular footprint that is
never consulted (Agent.h:6-26, SURVEY.md §2.1 'Agent model'). This module
realizes that latent intent: the agent body is the wheelbase-long,
``width``-wide rectangle extending FORWARD from the pose point
(models.Agent.footprint_ccw — rear axle at the pose, front axle at
pose + L*heading), tested against every obstacle with the 2-D separating-axis
theorem (4 axes: the two world axes + the two body axes).

Everything is broadcast-vectorized elementwise math that XLA fuses
straight into the rollout loop, mirroring how the broad phase is fused
(geometry/aabb.py). Touching boxes do NOT collide (>= separation), matching
the reference's broad-phase convention, and degenerate padding boxes
(max < min) are explicitly masked out.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def footprint_clear(
    x: Array,  # [...] pose x (rear axle)
    y: Array,  # [...] pose y
    theta: Array,  # [...] heading (broadcastable with x; pass 0.0 for none)
    half_len: float,
    half_wid: float,
    obstacles: Array,  # [K, 4] xmin, ymin, xmax, ymax
) -> Array:
    """True iff the oriented footprint rectangle overlaps NO obstacle.

    The rectangle is centered ``half_len`` ahead of (x, y) along ``theta``
    with half extents (half_len, half_wid) — i.e. the body spans
    [0, 2*half_len] x [-half_wid, half_wid] in the agent frame, exactly
    models.Agent.footprint_ccw.
    """
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    cx = x + half_len * ct  # body center
    cy = y + half_len * st
    act, ast = jnp.abs(ct), jnp.abs(st)

    bcx = (obstacles[:, 0] + obstacles[:, 2]) * 0.5  # [K]
    bcy = (obstacles[:, 1] + obstacles[:, 3]) * 0.5
    bhx = (obstacles[:, 2] - obstacles[:, 0]) * 0.5
    bhy = (obstacles[:, 3] - obstacles[:, 1]) * 0.5
    # padding rows have max < min (negative half extents); real obstacles
    # may be zero-thickness walls, so the cut is at 0, not above it
    valid_box = (bhx >= 0) & (bhy >= 0)

    dx = cx[..., None] - bcx  # [..., K]
    dy = cy[..., None] - bcy
    act_k, ast_k = act[..., None], ast[..., None]
    ct_k, st_k = ct[..., None], st[..., None]

    # world x / y axes: |center delta| >= sum of projection radii (touching
    # counts as separated, matching collisionCheck.cu:8-13's <=)
    sep_x = jnp.abs(dx) >= bhx + half_len * act_k + half_wid * ast_k
    sep_y = jnp.abs(dy) >= bhy + half_len * ast_k + half_wid * act_k
    # body axes u = (cos, sin), v = (-sin, cos)
    sep_u = jnp.abs(dx * ct_k + dy * st_k) >= half_len + bhx * act_k + bhy * ast_k
    sep_v = jnp.abs(dy * ct_k - dx * st_k) >= half_wid + bhx * ast_k + bhy * act_k

    hit = valid_box & ~(sep_x | sep_y | sep_u | sep_v)  # [..., K]
    return ~jnp.any(hit, axis=-1)


def footprint_corners(x, y, theta, half_len: float, half_wid: float):
    """CCW world-frame corners of the footprint at pose(s) — for tests and
    visualization overlays. Returns [..., 4, 2]."""
    ct, st = jnp.cos(theta), jnp.sin(theta)
    local = jnp.asarray(
        [[0.0, -half_wid], [2 * half_len, -half_wid],
         [2 * half_len, half_wid], [0.0, half_wid]], jnp.float32
    )  # agent frame, rear axle at origin (models.Agent.footprint_ccw)
    wx = x[..., None] + local[:, 0] * ct[..., None] - local[:, 1] * st[..., None]
    wy = y[..., None] + local[:, 0] * st[..., None] + local[:, 1] * ct[..., None]
    return jnp.stack([wx, wy], axis=-1)
