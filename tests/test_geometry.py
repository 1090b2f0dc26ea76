"""Unit tests for geometry (SURVEY.md §4.1): swept-AABB truth table vs the
reference's separating-axis test (collisionCheck.cu:6-14), R1/R2 indexing
incl. boundary and out-of-range -> -1 (KGMT.cu:602-629)."""

import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.geometry.aabb import (
    point_in_any_obstacle,
    segment_aabb,
    segments_clear_batch,
)
from cudasbmp_jax.geometry.grid import OccupancyGrid, RegionGrid


def reference_is_broad_phase_valid(bb_min, bb_max, obs):
    """Transcription of isBroadPhaseValid (collisionCheck.cu:6-14)."""
    for d in range(2):
        if bb_max[d] <= obs[d] or obs[2 + d] <= bb_min[d]:
            return True
    return False


def test_segment_clear_truth_table_vs_reference(rng):
    obstacles = np.array([[2.0, 2.0, 4.0, 4.0], [7.0, 2.0, 9.0, 5.0]], np.float32)
    p0 = rng.uniform(0, 10, size=(500, 2)).astype(np.float32)
    p1 = (p0 + rng.uniform(-1, 1, size=(500, 2))).astype(np.float32)
    got = np.array(segments_clear_batch(jnp.asarray(p0), jnp.asarray(p1),
                                        jnp.asarray(obstacles)))
    bb_min, bb_max = np.minimum(p0, p1), np.maximum(p0, p1)
    for i in range(500):
        want = all(
            reference_is_broad_phase_valid(bb_min[i], bb_max[i], obs)
            for obs in obstacles
        )
        assert got[i] == want, f"segment {i}: got {got[i]} want {want}"


def test_touching_boxes_do_not_collide():
    # separating test uses <=: touching is clear (collisionCheck.cu:10)
    obstacles = jnp.array([[2.0, 2.0, 4.0, 4.0]])
    clear = segments_clear_batch(
        jnp.array([[1.0, 1.0]]), jnp.array([[2.0, 2.0]]), obstacles
    )
    assert bool(clear[0])


def test_degenerate_padding_boxes_never_collide():
    pad = jnp.array([[1.0, 1.0, 0.0, 0.0]])  # max < min
    clear = segments_clear_batch(jnp.array([[0.0, 0.0]]), jnp.array([[5.0, 5.0]]), pad)
    assert bool(clear[0])


def test_segment_aabb():
    bb_min, bb_max = segment_aabb(jnp.array([3.0, 1.0]), jnp.array([2.0, 4.0]))
    np.testing.assert_allclose(np.array(bb_min), [2.0, 1.0])
    np.testing.assert_allclose(np.array(bb_max), [3.0, 4.0])


def reference_get_r1(x, y, r1_size, N):
    cell_x, cell_y = int(x / r1_size), int(y / r1_size)
    if 0 <= cell_x < N and 0 <= cell_y < N:
        return cell_y * N + cell_x
    return -1


def reference_get_r2(x, y, r1, r1_size, N, r2_size, n):
    if r1 == -1:
        return -1
    cy, cx = r1 // N, r1 % N
    lx, ly = x - cx * r1_size, y - cy * r1_size
    c2x, c2y = int(lx / r2_size), int(ly / r2_size)
    if 0 <= c2x < n and 0 <= c2y < n:
        return r1 * n * n + c2y * n + c2x
    return -1


def test_region_indices_vs_reference(rng):
    grid = RegionGrid(width=20.0, height=20.0, N=16, n=8)
    pts = rng.uniform(-2, 22, size=(2000, 2)).astype(np.float32)
    r1, r2 = grid.region_indices(jnp.asarray(pts))
    r1, r2 = np.array(r1), np.array(r2)
    for i, (x, y) in enumerate(pts):
        w1 = reference_get_r1(x, y, grid.r1_size, grid.N)
        w2 = reference_get_r2(x, y, w1, grid.r1_size, grid.N, grid.r2_size, grid.n)
        assert r1[i] == w1, (x, y, r1[i], w1)
        assert r2[i] == w2, (x, y, r2[i], w2)


def test_region_grid_boundaries():
    grid = RegionGrid(width=20.0, height=20.0, N=16, n=8)
    # exactly on the far edge -> out of grid (cell == N)
    assert int(grid.r1_index(jnp.float32(20.0), jnp.float32(1.0))) == -1
    # origin is cell 0
    assert int(grid.r1_index(jnp.float32(0.0), jnp.float32(0.0))) == 0
    # C-style truncation: x in (-cell, 0) truncates to cell 0, like the
    # reference's static_cast<int> (KGMT.cu:603-604)
    assert int(grid.r1_index(jnp.float32(-0.5), jnp.float32(1.0))) == 0
    # clearly out of range
    assert int(grid.r1_index(jnp.float32(-5.0), jnp.float32(1.0))) == -1


def test_occupancy_grid_counts():
    grid = RegionGrid(width=20.0, height=20.0, N=4, n=2)
    occ = OccupancyGrid.create(grid)
    # NB: x in (-cell, 0) truncates into cell 0 (C-cast semantics), so use
    # a point beyond a full cell width to be out of range.
    pts = jnp.array([[1.0, 1.0], [2.0, 2.0], [19.0, 19.0], [-7.0, 0.0]])
    occ = occ.add_points(pts)
    assert int(occ.occupancy(jnp.float32(1.5), jnp.float32(1.5))) == 2
    assert int(occ.occupancy(jnp.float32(19.0), jnp.float32(19.0))) == 1
    assert int(occ.occupancy(jnp.float32(-7.0), jnp.float32(0.0))) == 0
    assert int(occ.counts.sum()) == 3  # out-of-grid point dropped


def test_point_in_any_obstacle():
    obstacles = jnp.array([[2.0, 2.0, 4.0, 4.0]])
    assert bool(point_in_any_obstacle(jnp.array([3.0, 3.0]), obstacles))
    assert not bool(point_in_any_obstacle(jnp.array([5.0, 3.0]), obstacles))
    assert not bool(point_in_any_obstacle(jnp.array([2.0, 3.0]), obstacles))
