"""Swept-AABB broad-phase collision against axis-aligned box obstacles.

Re-expresses the reference's per-thread serial obstacle loop
(collisionCheck.cu:6-28: ``isBroadPhaseValid`` separating-axis test inside
``isMotionValid``) as a broadcasted, vmap-friendly reduction: the
[batch, num_obstacles] comparison grid is elementwise work that XLA fuses
into the rollout. Like the reference there is no narrow phase — the motion segment's
AABB vs. the obstacle AABB is the whole test.

Obstacles are ``[K, 4]`` rows ``(xmin, ymin, xmax, ymax)``
(configurations/obstacles/obstacles.csv; helper.cu:11-34). Padding rows may use
degenerate boxes (max < min) which are separated from everything, so static
shapes need no extra mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def segment_aabb(p0: Array, p1: Array) -> tuple[Array, Array]:
    """AABB of a motion segment: elementwise min/max of its endpoints
    (statePropagator.cu:49-59). p0, p1: [..., 2] -> (bb_min, bb_max)."""
    return jnp.minimum(p0, p1), jnp.maximum(p0, p1)


def segment_clear(bb_min: Array, bb_max: Array, obstacles: Array) -> Array:
    """True iff the segment AABB overlaps NO obstacle.

    The reference's separating-axis test (collisionCheck.cu:8-13) declares a
    pair clear when on any axis ``bbMax[d] <= obs_min[d]`` or
    ``obs_max[d] <= bbMin[d]`` — touching boxes do NOT collide.

    bb_min, bb_max: [..., 2]; obstacles: [K, 4]. Returns bool [...].
    """
    omin = obstacles[:, 0:2]  # [K, 2]
    omax = obstacles[:, 2:4]  # [K, 2]
    # [..., 1, 2] vs [K, 2] -> [..., K, 2]
    sep = (bb_max[..., None, :] <= omin) | (omax <= bb_min[..., None, :])
    pair_clear = jnp.any(sep, axis=-1)  # separated on any axis  [..., K]
    return jnp.all(pair_clear, axis=-1)  # clear of every obstacle [...]


def segments_clear_batch(p0: Array, p1: Array, obstacles: Array) -> Array:
    """Batched convenience: p0, p1 [..., 2] endpoint arrays -> bool [...]."""
    bb_min, bb_max = segment_aabb(p0, p1)
    return segment_clear(bb_min, bb_max, obstacles)


def point_in_any_obstacle(p: Array, obstacles: Array) -> Array:
    """True iff point p [..., 2] lies strictly inside any obstacle box."""
    omin = obstacles[:, 0:2]
    omax = obstacles[:, 2:4]
    inside = jnp.all((p[..., None, :] > omin) & (p[..., None, :] < omax), axis=-1)
    return jnp.any(inside, axis=-1)
