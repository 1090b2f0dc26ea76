"""Tests for the host data model (Sample/Agent parity layer), the state
invariant validator, recorded mode, and config-file loading."""

from pathlib import Path

import numpy as np
import pytest

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.models import Agent, Sample
from cudasbmp_jax.planners.kgmt import KGMT
from cudasbmp_jax.utils.validate import InvariantViolation, validate_state


def test_sample_roundtrip():
    s = Sample(1, 2, 0.5, 1.5, -2.0, 0.3, 0.7)
    arr = s.to_array()
    assert arr.shape == (7,)
    s2 = Sample.from_array(arr)
    np.testing.assert_allclose(s2.to_array(), arr)  # f32 round-trip exact
    np.testing.assert_allclose(s.state, [1, 2, 0.5, 1.5])
    np.testing.assert_allclose(s.control, [-2.0, 0.3, 0.7])


def test_agent_update_matches_system():
    """Agent::updateState parity (Agent.cpp:19-25) via the shared dynamics."""
    a = Agent(x=1.0, y=2.0, theta=0.7, v=1.5, length=1.0)
    a.update_state(a=2.0, delta=0.3, dt=0.05)
    import math

    assert a.x == pytest.approx(1.0 + 1.5 * math.cos(0.7) * 0.05, rel=1e-6)
    assert a.v == pytest.approx(1.5 + 2.0 * 0.05, rel=1e-6)


def test_agent_footprint():
    a = Agent(x=5.0, y=5.0, theta=0.0, length=2.0, width=1.0)
    fp = a.footprint_ccw()
    assert fp.shape == (4, 2)
    np.testing.assert_allclose(fp[0], [5.0, 4.5])
    np.testing.assert_allclose(fp[2], [7.0, 5.5])
    # rotation by pi/2 sends the nose upward
    a.theta = np.pi / 2
    fp = a.footprint_ccw()
    np.testing.assert_allclose(fp[1], [5.5, 7.0], atol=1e-6)


def test_validate_state_passes_on_real_solve(small_config, demo_scenario):
    result = KGMT(small_config).plan(demo_scenario)
    summary = validate_state(result.state, small_config)
    assert summary["solved"]
    assert summary["tree_size"] == result.tree_size
    assert summary["max_depth"] >= len(result.path) - 1


def test_validate_state_catches_corruption(small_config, demo_scenario):
    result = KGMT(small_config).plan(demo_scenario)
    bad = result.state._replace(
        tree_parent=result.state.tree_parent.at[5].set(100000)
    )
    with pytest.raises(InvariantViolation):
        validate_state(bad, small_config)
    bad2 = result.state._replace(
        costs=result.state.costs.at[10].set(-5.0)
    )
    with pytest.raises(InvariantViolation):
        validate_state(bad2, small_config)


@pytest.mark.slow
def test_plan_recorded_dumps_and_checkpoints(tmp_path):
    cfg = KGMTConfig(num_iterations=30, max_tree_size=16384,
                     rollouts_per_iter=2048)
    result = KGMT(cfg).plan_recorded(
        Scenario.demo(), tmp_path, dump_every=1, checkpoint_every=3
    )
    assert result.solved
    assert (tmp_path / "Samples" / "samples1.csv").exists()
    assert (tmp_path / "Parents" / "parents1.csv").exists()
    assert (tmp_path / "R1Scores" / "R1Scores1.csv").exists()
    assert (tmp_path / "checkpoint_3.npz").exists()
    # staging-buffer replay artifacts (unexploredSamples/uParentIdx parity):
    # every committed tree row of wave 1 must appear verbatim in the replayed
    # staging buffer (the reference's updateG copies accepted rows from it,
    # KGMT.cu:568-575)
    staged = np.loadtxt(
        tmp_path / "UnexploredSamples" / "unexploredSamples1.csv",
        delimiter=",")
    samples1 = np.loadtxt(tmp_path / "Samples" / "samples1.csv",
                          delimiter=",")
    parents1 = np.loadtxt(tmp_path / "Parents" / "parents1.csv",
                          delimiter=",")
    committed = samples1[1:int((parents1 >= 0).sum()) + 1]
    staged_set = {tuple(np.round(r, 5)) for r in staged}
    for row in committed:
        assert tuple(np.round(row, 5)) in staged_set
    # recorded mode matches plan() exactly (same seed, same RNG stream)
    direct = KGMT(cfg).plan(Scenario.demo())
    assert result.cost == direct.cost
    assert result.tree_size == direct.tree_size


def test_invariants_fuzz_random_scenarios():
    """Property fuzz: every invariant holds on random obstacle fields, goals
    reachable or not, across systems — the automated stand-in for the
    sanitizer runs the reference never had (SURVEY.md §5)."""
    import jax

    from cudasbmp_jax.parallel.monte_carlo import random_scenarios
    from cudasbmp_jax.utils.validate import validate_state

    cfg = KGMTConfig(num_iterations=40, max_tree_size=4096,
                     rollouts_per_iter=512)
    inits, goals, obstacles = random_scenarios(
        jax.random.key(42), 6, cfg, num_obstacles=8
    )
    planner = KGMT(cfg)
    solved = 0
    for i in range(6):
        sc = Scenario(init=inits[i], goal=goals[i],
                      obstacles=obstacles[i][:8])
        result = planner.plan(sc, seed=i)
        summary = validate_state(result.state, cfg)
        assert summary["max_depth"] <= result.iterations
        solved += int(result.solved)
    assert solved >= 3  # random 8-obstacle fields are mostly solvable


def test_config_validation_rejects_bad_values():
    import pytest

    for kw in ({"N": 0}, {"num_disc": 0}, {"rollouts_per_iter": 0},
               {"fanout": -1}, {"width": 0.0}, {"goal_threshold": -1.0},
               {"rollout_backend": "cuda"}):
        with pytest.raises(ValueError, match="invalid KGMTConfig"):
            KGMTConfig(**kw)
    KGMTConfig(num_iterations=0)  # zero budget is legal (no-op plan)


def test_config_from_car_yaml():
    cfg = KGMTConfig.from_file("systems/car.yaml")
    assert cfg.system == "bicycle"
    assert cfg.max_tree_size == 30000
    assert cfg.N == 16 and cfg.n == 8


@pytest.mark.parametrize("name,system", [("car", "bicycle"),
                                         ("unicycle", "unicycle"),
                                         ("dubins", "dubins")])
def test_flat_yaml_loader_reads_system_files(name, system):
    """The PyYAML-free reader: every systems/*.yaml loads, with its typed
    values, and survives a write/read round trip."""
    import tempfile
    from pathlib import Path

    from cudasbmp_jax.config import parse_flat_yaml

    path = Path("systems") / f"{name}.yaml"
    data = parse_flat_yaml(path.read_text())
    assert data["system"] == system
    assert isinstance(data["N"], int) and isinstance(data["width"], float)
    cfg = KGMTConfig.from_file(str(path))
    assert cfg == KGMTConfig.from_dict(data)
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "cfg.yaml")
        cfg.replace(need_path=False, goal_bias=0.25).to_file(out)
        assert KGMTConfig.from_file(out) == cfg.replace(need_path=False,
                                                        goal_bias=0.25)


def test_flat_yaml_loader_rejects_nested_values():
    from cudasbmp_jax.config import parse_flat_yaml

    assert parse_flat_yaml("a: 'x # y'  # c\nb: true\nc: ~\n") == {
        "a": "x # y", "b": True, "c": None}
    for bad in ("a:\n  b: 1\n", "a: [1, 2]\n", "just text\n"):
        with pytest.raises(ValueError):
            parse_flat_yaml(bad)


@pytest.mark.parametrize("env_set", [False, True], ids=["default", "env"])
def test_compilation_cache_location(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set over it; without
    it the cache goes to the fixed <checkout>/.jax_cache."""
    import jax

    from cudasbmp_jax.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            monkeypatch.setattr(jax.config, "update", None)  # must not run
            assert cache.enable_compilation_cache() == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = cache.enable_compilation_cache()
            assert path == str(cache.DEFAULT_CACHE_DIR)
            assert cache.DEFAULT_CACHE_DIR.parent == Path(__file__).resolve(
            ).parents[1]
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", before)


def test_load_repo_configurations():
    from cudasbmp_jax.io.csv import load_scenario

    scenario, grid = load_scenario("configurations")
    np.testing.assert_allclose(scenario.init[:2], [1.0, 1.0])
    assert scenario.obstacles.shape == (5, 4)
    # numR2.csv carries the reference's value 16 — which its own demo
    # IGNORES in favor of a hardcoded n=8 (demos/main.cu:22 vs
    # configurations/R2/numR2.csv; SURVEY.md §2.4.10). The loader reports the
    # file's value faithfully; honoring-vs-overriding is the caller's choice.
    assert grid["N"] == 16 and grid["n"] == 16
