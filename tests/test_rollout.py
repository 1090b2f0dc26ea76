"""Rollout tests: lockstep-masked integration vs a literal Python
transcription of propagateAndCheck (statePropagator.cu:5-76), break-semantics
parity, bounds handling."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from cudasbmp_jax.ops.rollout import propagate_and_check, rollout_batch
from cudasbmp_jax.systems import KinematicBicycle


def reference_propagate_and_check(x0, a, steering, duration, num_disc,
                                  agent_length, obstacles, width, height):
    """Literal Python transcription of statePropagator.cu:21-76 given already
    sampled controls. Returns (x1_state, motion_valid)."""
    dt = duration / num_disc
    x, y, theta, v = x0
    motion_valid = True
    for _ in range(num_disc):
        vx, vy = x, y
        cos_t, sin_t, tan_s = math.cos(theta), math.sin(theta), math.tan(steering)
        x += v * cos_t * dt
        y += v * sin_t * dt
        if x <= 0.0 or x >= width or y <= 0.0 or y >= height:
            motion_valid = False
            break
        theta += (v / agent_length) * tan_s * dt
        v += a * dt
        bb_min = (min(vx, x), min(vy, y))
        bb_max = (max(vx, x), max(vy, y))
        for obs in obstacles:
            separated = any(
                bb_max[d] <= obs[d] or obs[2 + d] <= bb_min[d] for d in range(2)
            )
            if not separated:
                motion_valid = False
                break
        if not motion_valid:
            break
    return np.array([x, y, theta, v]), motion_valid


def test_rollout_matches_reference_transcription(rng):
    sys_ = KinematicBicycle()
    obstacles = np.array(
        [[2.0, 2.0, 4.0, 4.0], [7.0, 2.0, 9.0, 5.0], [0.0, 6.0, 18.0, 8.0]],
        np.float32,
    )
    B = 256
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, B)
    x0[:, 1] = rng.uniform(0.5, 19.5, B)
    x0[:, 2] = rng.uniform(-3, 3, B)
    x0[:, 3] = rng.uniform(-2, 2, B)
    controls = np.zeros((B, 3), np.float32)
    controls[:, 0] = rng.uniform(-5, 5, B)
    controls[:, 1] = rng.uniform(-math.pi, math.pi, B)
    controls[:, 2] = rng.uniform(0.05, 1.05, B)

    x1, valid = rollout_batch(
        sys_, jnp.asarray(x0), jnp.asarray(controls), 10,
        jnp.asarray(obstacles), 20.0, 20.0,
    )
    x1, valid = np.array(x1), np.array(valid)

    n_valid = 0
    for i in range(B):
        want_x1, want_valid = reference_propagate_and_check(
            x0[i].astype(np.float64), controls[i, 0], controls[i, 1],
            controls[i, 2], 10, 1.0, obstacles, 20.0, 20.0,
        )
        assert valid[i] == want_valid, f"rollout {i} validity mismatch"
        if want_valid:
            n_valid += 1
            np.testing.assert_allclose(x1[i], want_x1, rtol=2e-4, atol=2e-4)
        else:
            # invalid rollouts freeze at the failing step; position parity
            # matters for region stats
            np.testing.assert_allclose(x1[i, :2], want_x1[:2], rtol=2e-4, atol=2e-4)
    assert n_valid > 10  # sanity: scenario isn't degenerate


def test_propagate_and_check_full(rng):
    """End-to-end with control sampling: samples are final-state + control,
    all valid samples in bounds and collision-free."""
    sys_ = KinematicBicycle()
    obstacles = jnp.array([[2.0, 2.0, 4.0, 4.0]])
    B = 512
    x0 = jnp.tile(jnp.array([5.0, 5.0, 0.0, 0.0]), (B, 1))
    samples, controls, valid = propagate_and_check(
        sys_, jax.random.key(0), x0, obstacles,
        num_disc=10, width=20.0, height=20.0,
    )
    samples, valid = np.array(samples), np.array(valid)
    assert samples.shape == (B, 7)
    assert valid.sum() > 100
    v = samples[valid]
    assert (v[:, 0] > 0).all() and (v[:, 0] < 20).all()
    assert (v[:, 1] > 0).all() and (v[:, 1] < 20).all()
    # no valid endpoint strictly inside the obstacle
    inside = (
        (v[:, 0] > 2) & (v[:, 0] < 4) & (v[:, 1] > 2) & (v[:, 1] < 4)
    )
    assert not inside.any()


def test_replay_invariant(rng):
    """Property test (SURVEY.md §4.2): re-integrating a sample's stored
    control from its start state reproduces the stored final state — the
    MATLAB cross-check (visualizationKGMT_Single.m:86-112), automated."""
    sys_ = KinematicBicycle()
    obstacles = jnp.zeros((0, 4))
    B = 128
    x0 = jnp.asarray(rng.uniform(2, 18, size=(B, 4)).astype(np.float32))
    samples, controls, valid = propagate_and_check(
        sys_, jax.random.key(7), x0, obstacles,
        num_disc=10, width=20.0, height=20.0,
    )
    # replay: deterministic rollout of the SAME control
    x1_replay, _ = rollout_batch(sys_, x0, samples[:, 4:7], 10, obstacles, 20.0, 20.0)
    np.testing.assert_allclose(
        np.array(x1_replay)[np.array(valid)],
        np.array(samples[:, :4])[np.array(valid)],
        rtol=1e-5, atol=1e-5,
    )


def test_zero_obstacles_and_infinite_bounds():
    sys_ = KinematicBicycle()
    # start at y=1 (bounds are exclusive: y=0 exactly is already invalid)
    x0 = jnp.zeros((16, 4)).at[:, 3].set(100.0).at[:, 1].set(1.0)
    controls = jnp.zeros((16, 3)).at[:, 2].set(1.0)
    x1, valid = rollout_batch(
        sys_, x0, controls, 10, jnp.zeros((0, 4)), float("inf"), float("inf")
    )
    assert bool(np.array(valid).all())
    np.testing.assert_allclose(np.array(x1)[:, 0], 100.0, rtol=1e-5)
