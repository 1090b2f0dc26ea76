"""Rollouts against a plain NumPy reference of the original's semantics.

``reference_rollout`` restates ``propagateAndCheck`` (statePropagator.cu:
5-76) lane by lane, independently of the JAX code: ``num_disc`` explicit
Euler steps of dt = duration / num_disc, each step's new position tested
against the workspace bounds (exclusive) and its swept AABB against every
obstacle, and an exit at the first failure with the state frozen at that
step's candidate. The dynamics are written out again per system below.
"""

import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from cudasbmp_jax.config import Scenario
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.ops.rollout_pallas import rollout_pallas
from cudasbmp_jax.systems.registry import get_system

F = np.float32
W = H = 20.0
NUM_DISC = 10


def _bicycle(s, u, dt, L=1.0):
    x, y, th, v = s
    a, steer = u
    return (x + v * F(math.cos(th)) * dt, y + v * F(math.sin(th)) * dt,
            th + (v / F(L)) * F(math.tan(steer)) * dt, v + a * dt)


def _unicycle(s, u, dt):
    x, y, th, _ = s
    v, omega = u
    return (x + v * F(math.cos(th)) * dt, y + v * F(math.sin(th)) * dt,
            th + omega * dt, F(0))


def _dubins(s, u, dt):
    x, y, th, _ = s
    v, kappa = u
    return (x + v * F(math.cos(th)) * dt, y + v * F(math.sin(th)) * dt,
            th + v * kappa * dt, F(0))


def _point2d(s, u, dt):
    vx, vy = u
    return (s[0] + vx * dt, s[1] + vy * dt, F(0), F(0))


def _double_integrator(s, u, dt):
    x, y, vx, vy = s
    ax, ay = u
    return (x + vx * dt, y + vy * dt, vx + ax * dt, vy + ay * dt)


STEPS = {"bicycle": _bicycle, "unicycle": _unicycle, "dubins": _dubins,
         "point2d": _point2d, "double_integrator": _double_integrator}


def reference_rollout(name, x0, controls, obstacles, num_disc=NUM_DISC):
    """Lane-by-lane propagate-and-check in float32; returns (x1, valid)."""
    step = STEPS[name]
    x1 = np.empty_like(x0)
    valid = np.ones(len(x0), bool)
    for i, (s, c) in enumerate(zip(x0, controls)):
        s = tuple(F(v) for v in s)
        u = tuple(F(v) for v in c[:-1])
        dt = F(c[-1]) / F(num_disc)
        for _ in range(num_disc):
            new = tuple(F(v) for v in step(s, u, dt))
            nx, ny = new[0], new[1]
            ok = 0.0 < nx < W and 0.0 < ny < H
            lo_x, hi_x = min(s[0], nx), max(s[0], nx)
            lo_y, hi_y = min(s[1], ny), max(s[1], ny)
            for oxmin, oymin, oxmax, oymax in obstacles:
                if not (hi_x <= oxmin or oxmax <= lo_x
                        or hi_y <= oymin or oymax <= lo_y):
                    ok = False
            s = new
            if not ok:
                valid[i] = False
                break
        x1[i] = s
    return x1, valid


def _batch(system, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, system.state_dim), np.float32)
    x0[:, :2] = rng.uniform(0.5, 19.5, (B, 2))
    if system.name in ("bicycle", "unicycle", "dubins"):
        x0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    if system.name in ("bicycle", "double_integrator"):
        x0[:, 3:] = rng.uniform(-2, 2, (B, system.state_dim - 3))
    if system.name == "double_integrator":
        x0[:, 2] = rng.uniform(-2, 2, B)
    spec = system.control_spec
    u = rng.uniform(0, 1, (B, spec.dim))
    controls = (np.asarray(spec.lo) + u * (np.asarray(spec.hi)
                                           - np.asarray(spec.lo)))
    return x0, controls.astype(np.float32)


FIELDS = {
    "open": np.zeros((0, 4), np.float32),
    "demo": Scenario.demo().obstacles,
    "dense24": Scenario.dense(24).obstacles,
}


def _compare(name, x1, valid, x1_ref, valid_ref):
    # float32 in another operation order may flip a lane that grazes a
    # boundary; anything beyond a stray lane is a semantic difference
    agree = valid == valid_ref
    assert agree.mean() >= 0.995, (name, agree.mean())
    both = agree & valid_ref
    np.testing.assert_allclose(x1[both, :2], x1_ref[both, :2], rtol=1e-4,
                               atol=1e-4)
    assert 0.0 < valid_ref.mean() <= 1.0


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("name", sorted(STEPS))
def test_rollout_batch_matches_numpy_reference(name, field):
    system = get_system(name)
    x0, controls = _batch(system, 400,
                          seed=zlib.crc32(f"{name}/{field}".encode()))
    obstacles = FIELDS[field]
    x1_ref, valid_ref = reference_rollout(name, x0, controls, obstacles)
    x1, valid = rollout_batch(system, jnp.asarray(x0), jnp.asarray(controls),
                              NUM_DISC, jnp.asarray(obstacles), W, H)
    _compare(name, np.asarray(x1), np.asarray(valid), x1_ref, valid_ref)
    if field == "dense24":
        assert valid_ref.mean() < 1.0  # the field must kill some rollouts


@pytest.mark.parametrize("B", [1, 1000, 4097])
def test_kernel_interpret_matches_numpy_reference(B):
    """The Triton-route kernel, interpreted, on lane counts that are not a
    multiple of its block, with the obstacle set padded by degenerate
    boxes to max_obstacles."""
    system = get_system("bicycle")
    x0, controls = _batch(system, B, seed=B)
    sc = Scenario.dense(24)
    padded, _ = sc.padded_obstacles(32, pad_to=32)
    x1, valid = rollout_pallas(system, jnp.asarray(x0), jnp.asarray(controls),
                               jnp.asarray(padded), num_disc=NUM_DISC,
                               width=W, height=H, interpret=True)
    assert x1.shape == (B, 4) and valid.shape == (B,)
    x1_ref, valid_ref = reference_rollout("bicycle", x0, controls,
                                          sc.obstacles)
    _compare("bicycle", np.asarray(x1), np.asarray(valid), x1_ref, valid_ref)
