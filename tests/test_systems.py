"""Unit tests for the systems layer (SURVEY.md §4.1): bicycle step vs the
reference's Agent::updateState semantics (Agent.cpp:19-25), control sampling
ranges (statePropagator.cu:17-19), registry behavior."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudasbmp_jax.systems import (
    DoubleIntegrator2D,
    DubinsCar,
    KinematicBicycle,
    Point2D,
    Unicycle,
    available_systems,
    get_system,
)


def reference_bicycle_step(state, a, steering, dt, L=1.0):
    """Literal transcription of the update equations (Agent.cpp:19-25):
    position uses pre-step theta and v."""
    x, y, theta, v = state
    return np.array(
        [
            x + v * math.cos(theta) * dt,
            y + v * math.sin(theta) * dt,
            theta + (v / L) * math.tan(steering) * dt,
            v + a * dt,
        ]
    )


def test_bicycle_step_matches_reference_semantics():
    sys_ = KinematicBicycle()
    state = jnp.array([1.0, 2.0, 0.7, 1.5])
    control = jnp.array([2.0, 0.3])
    dt = jnp.float32(0.05)
    got = sys_.step(state, control, dt)
    want = reference_bicycle_step(np.array(state), 2.0, 0.3, 0.05)
    np.testing.assert_allclose(np.array(got), want, rtol=1e-6)


def test_bicycle_step_batched_matches_loop():
    sys_ = KinematicBicycle()
    key = jax.random.key(0)
    states = jax.random.normal(key, (32, 4))
    controls = jax.random.normal(jax.random.key(1), (32, 2))
    dt = jnp.full(32, 0.1)
    batched = sys_.step(states, controls, dt)
    for i in range(32):
        single = sys_.step(states[i], controls[i], dt[i])
        np.testing.assert_allclose(np.array(batched[i]), np.array(single), rtol=1e-6)


def test_control_sampling_ranges():
    """a in [-5,5], steering in [-pi,pi], duration in [0.05,1.05] — the code
    ranges, not the stale comments (SURVEY.md §2.4.3)."""
    sys_ = KinematicBicycle()
    c = sys_.control_spec.sample(jax.random.key(0), (10000,))
    c = np.array(c)
    assert c.shape == (10000, 3)
    assert c[:, 0].min() >= -5.0 and c[:, 0].max() <= 5.0
    assert c[:, 1].min() >= -math.pi and c[:, 1].max() <= math.pi
    assert c[:, 2].min() >= 0.05 and c[:, 2].max() <= 1.05
    # distribution sanity: roughly uniform
    assert abs(c[:, 0].mean()) < 0.2
    assert 0.5 < c[:, 2].mean() < 0.6


def test_point2d_and_double_integrator_step():
    p = Point2D()
    s = p.step(jnp.array([1.0, 1.0, 0.0, 0.0]), jnp.array([1.0, -1.0]), 0.5)
    np.testing.assert_allclose(np.array(s), [1.5, 0.5, 0.0, 0.0], rtol=1e-6)

    d = DoubleIntegrator2D()
    s = d.step(jnp.array([0.0, 0.0, 1.0, 2.0]), jnp.array([1.0, 1.0]), 0.5)
    # position integrates pre-step velocity
    np.testing.assert_allclose(np.array(s), [0.5, 1.0, 1.5, 2.5], rtol=1e-6)


def test_unicycle_step():
    u = Unicycle()
    # straight line when omega = 0
    s = u.step(jnp.array([1.0, 1.0, 0.0, 0.0]), jnp.array([2.0, 0.0]), 0.5)
    np.testing.assert_allclose(np.array(s), [2.0, 1.0, 0.0, 0.0], rtol=1e-6)
    # pure rotation when v = 0
    s = u.step(jnp.array([1.0, 1.0, 0.0, 0.0]), jnp.array([0.0, 1.0]), 0.5)
    np.testing.assert_allclose(np.array(s), [1.0, 1.0, 0.5, 0.0], rtol=1e-6)


def test_unicycle_closes_circle():
    """Integrating v=r*omega for a full period traces a circle back to the
    start (up to Euler error ~ O(dt))."""
    u = Unicycle()
    v, omega = 1.0, 1.0  # radius 1 circle, period 2*pi
    n = 4000
    dt = jnp.float32(2 * math.pi / n)
    state = jnp.array([0.0, 0.0, 0.0, 0.0])
    control = jnp.array([v, omega])

    def body(s, _):
        return u.step(s, control, dt), None

    final, _ = jax.lax.scan(body, state, None, length=n)
    final = np.array(final)
    assert abs(final[0]) < 0.01 and abs(final[1]) < 0.01
    # f32 accumulation of 4000 dt additions drifts ~4e-5 relative
    np.testing.assert_allclose(final[2], 2 * math.pi, rtol=1e-3)


def test_dubins_turn_radius_speed_invariant():
    """theta' = v*kappa: arc length per unit heading change is 1/kappa
    regardless of speed — the defining Dubins property."""
    d = DubinsCar()
    n = 2000
    for v in (0.5, 2.0):
        dt = jnp.float32((math.pi / 2) / (v * 1.0) / n)  # quarter turn
        state = jnp.array([0.0, 0.0, 0.0, 0.0])
        control = jnp.array([v, 1.0])  # kappa = 1 -> radius 1

        def body(s, _):
            return d.step(s, control, dt), None

        final, _ = jax.lax.scan(body, state, None, length=n)
        final = np.array(final)
        # quarter circle of radius 1 from origin heading +x ends near (1, 1)
        np.testing.assert_allclose(final[0], 1.0, atol=0.01)
        np.testing.assert_allclose(final[1], 1.0, atol=0.01)


def test_dubins_forward_only_sampling():
    c = np.array(DubinsCar().control_spec.sample(jax.random.key(0), (4096,)))
    assert c[:, 0].min() >= 0.25  # speed never negative or zero


def test_registry():
    assert "bicycle" in available_systems()
    assert "car" in available_systems()
    assert get_system("car").name == "bicycle"
    assert get_system("bicycle", agent_length=2.0).agent_length == 2.0
    assert get_system("unicycle").name == "unicycle"
    assert get_system("dubins").name == "dubins"
    with pytest.raises(KeyError):
        get_system("warp_drive")
