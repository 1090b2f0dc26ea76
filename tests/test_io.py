"""IO tests: configurations/ loading (incl. the files the reference demo
ignores), reference-named artifact dumps, checkpoint round-trip + exact
resume, native CSV fast path."""

import numpy as np
import pytest

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.io.checkpoint import load_checkpoint, save_checkpoint
from cudasbmp_jax.io.csv import (
    load_scenario,
    read_obstacles_csv,
    read_sample_csv,
    write_artifacts,
    write_csv,
)
from cudasbmp_jax.planners.kgmt import KGMT


@pytest.fixture()
def config_dir(tmp_path):
    """A configurations/ tree in the reference layout."""
    (tmp_path / "init").mkdir()
    (tmp_path / "goal").mkdir()
    (tmp_path / "obstacles").mkdir()
    (tmp_path / "numR1").mkdir()
    (tmp_path / "R2").mkdir()
    (tmp_path / "init" / "init.csv").write_text("1.0,1.0,0,0,0,0,0")
    (tmp_path / "goal" / "goal.csv").write_text("9.0,9.0,0,0,0,0,0")
    (tmp_path / "obstacles" / "obstacles.csv").write_text(
        "2,2,4,4\n7,2,9,5\n3,18,6,20\n2,10,4,12\n0,6,18,8\n"
    )
    (tmp_path / "numR1" / "numR1.csv").write_text("16")
    (tmp_path / "R2" / "numR2.csv").write_text("16")
    return tmp_path


def test_load_scenario_honors_all_files(config_dir):
    scenario, grid = load_scenario(config_dir)
    np.testing.assert_allclose(scenario.init[:2], [1.0, 1.0])
    np.testing.assert_allclose(scenario.goal[:2], [9.0, 9.0])
    assert scenario.obstacles.shape == (5, 4)
    np.testing.assert_allclose(scenario.obstacles[4], [0, 6, 18, 8])
    assert grid == {"N": 16, "n": 16}


def test_read_sample_pads_short_rows(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("3.5,4.5")
    s = read_sample_csv(p)
    assert s.shape == (7,)
    np.testing.assert_allclose(s, [3.5, 4.5, 0, 0, 0, 0, 0])


def test_obstacles_csv_roundtrip(tmp_path):
    obs = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.float32)
    p = tmp_path / "o.csv"
    write_csv(obs, p, cols=4)
    got = read_obstacles_csv(p)
    np.testing.assert_allclose(got, obs)


def test_write_artifacts_names(tmp_path, small_config, demo_scenario):
    from cudasbmp_jax.io.csv import REFERENCE_ARTIFACT_NAMES

    result = KGMT(small_config).plan(demo_scenario)
    written = write_artifacts(result.state, small_config, tmp_path)
    names = {p.split("/")[-1] for p in written}
    # the default artifact file-name set EQUALS the reference's 13 exactly
    # (KGMT.cu:299-311)
    assert names == REFERENCE_ARTIFACT_NAMES == {
        "samples.csv", "unexploredSamples.csv", "parentRelations.csv",
        "uParentIdx.csv", "G.csv", "R2Avail.csv", "R1Avail.csv",
        "R1Valid.csv", "R2Valid.csv", "R1Invalid.csv", "R2Invalid.csv",
        "R1Score.csv", "R1.csv",
    }
    samples = np.loadtxt(tmp_path / "samples.csv", delimiter=",")
    assert samples.shape == (small_config.max_tree_size, 7)
    r1 = np.loadtxt(tmp_path / "R1.csv", delimiter=",")
    assert r1.shape == (small_config.num_r1,)
    # staging-buffer artifacts: last wave's rollouts + parent indices
    staged = np.loadtxt(tmp_path / "unexploredSamples.csv", delimiter=",")
    assert staged.shape == (small_config.rollouts_per_iter, 7)
    upar = np.loadtxt(tmp_path / "uParentIdx.csv", delimiter=",")
    assert upar.shape == (small_config.rollouts_per_iter,)
    assert (upar >= 0).any()
    # extras mode adds the two beyond-reference dumps on top
    extra = write_artifacts(result.state, small_config, tmp_path, extras=True)
    extra_names = {p.split("/")[-1] for p in extra}
    assert extra_names == REFERENCE_ARTIFACT_NAMES | {"R2.csv", "costs.csv"}


def test_checkpoint_roundtrip_and_exact_resume(small_config, demo_scenario, tmp_path):
    """Snapshot mid-solve, restore, resume: identical final outcome to an
    uninterrupted run (SURVEY.md §5 failure-recovery plan)."""
    # run A: uninterrupted
    full = KGMT(small_config).plan(demo_scenario)

    # run B: stop after 5 iterations, checkpoint, reload, resume
    cfg_short = small_config.replace(num_iterations=5)
    partial = KGMT(cfg_short).plan(demo_scenario)
    assert not partial.solved
    ckpt = tmp_path / "state.npz"
    save_checkpoint(partial.state, ckpt)
    restored = load_checkpoint(ckpt)
    for name in restored._fields:
        a, b = getattr(partial.state, name), getattr(restored, name)
        if name == "key":
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    resumed = KGMT(small_config).resume(restored, demo_scenario)
    assert resumed.solved == full.solved
    assert resumed.cost == full.cost
    assert resumed.tree_size == full.tree_size
    np.testing.assert_array_equal(resumed.path, full.path)


def test_native_csv_available_and_fast():
    from cudasbmp_jax.io.native import native_available

    assert native_available(), "native IO library should build in this image"


@pytest.mark.slow
def test_fault_injection_sigkill_and_resume(tmp_path):
    """Elastic-recovery demonstration (SURVEY.md §5): SIGKILL a solve
    mid-flight, restore the last intact checkpoint, and the resumed run
    finishes IDENTICALLY to an uninterrupted one (itr-keyed counter-based
    RNG makes resume exact regardless of where the kill landed)."""
    import os
    import signal
    import subprocess
    import sys
    import time as _time

    cfg = KGMTConfig(num_iterations=60, max_tree_size=16384,
                     rollouts_per_iter=2048, seed=3)
    sc = Scenario.demo()

    # reference outcome: uninterrupted solve in-process
    full = KGMT(cfg).plan(sc)
    assert full.solved

    # victim process: same solve, checkpointing every 2 iterations, slowed
    # by per-iteration dumps so the kill lands mid-solve
    code = f"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=1'
import jax; jax.config.update('jax_platforms', 'cpu')
import sys
sys.path.insert(0, {str(__import__('pathlib').Path(__file__).resolve().parent.parent)!r})
from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.planners.kgmt import KGMT
cfg = KGMTConfig(num_iterations=60, max_tree_size=16384,
                 rollouts_per_iter=2048, seed=3)
KGMT(cfg).plan_recorded(Scenario.demo(), {str(tmp_path)!r},
                        dump_every=1, checkpoint_every=2)
print('FINISHED_UNKILLED')
"""
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    # kill the instant the first checkpoint exists (mid-solve, possibly
    # mid-write of a later one)
    deadline = _time.time() + 300
    while _time.time() < deadline:
        if (tmp_path / "checkpoint_2.npz").exists():
            break
        if proc.poll() is not None:
            out, err = proc.communicate()
            raise AssertionError(
                f"victim exited before kill: {out!r} {err!r}")
        _time.sleep(0.05)
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    assert proc.returncode == -signal.SIGKILL

    # restore: newest checkpoint that loads intact (a torn half-written
    # file from the kill moment is skipped)
    ckpts = sorted(tmp_path.glob("checkpoint_*.npz"),
                   key=lambda p: int(p.stem.split("_")[1]), reverse=True)
    assert ckpts, "no checkpoint survived"
    state = None
    for p in ckpts:
        try:
            state = load_checkpoint(p)
            break
        except Exception:
            continue
    assert state is not None
    assert int(state.itr) >= 2

    resumed = KGMT(cfg).resume(state, sc)
    assert resumed.solved
    # bit-identical final outcome to the uninterrupted run
    assert resumed.cost == full.cost
    assert resumed.tree_size == full.tree_size
    assert resumed.iterations == full.iterations
    np.testing.assert_array_equal(resumed.path, full.path)


def test_pathless_checkpoint_roundtrip_and_resume(tmp_path):
    """PathlessState checkpoints round-trip (type marker dispatch) and a
    resumed pathless solve continues to the same result as uninterrupted."""
    import jax
    import jax.numpy as jnp

    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.geometry.grid import RegionGrid
    from cudasbmp_jax.io.checkpoint import load_checkpoint, save_checkpoint
    from cudasbmp_jax.planners.kgmt import (
        KGMT,
        PathlessState,
        init_pathless_state,
        kgmt_run_pathless,
    )
    from cudasbmp_jax.systems.registry import get_system

    cfg = KGMTConfig(num_iterations=60, max_tree_size=8192,
                     rollouts_per_iter=512, adaptive_waves=False,
                     need_path=False, seed=0)
    sc = Scenario.demo()
    planner = KGMT(cfg)
    full = planner.plan(sc, seed=6)
    assert full.solved

    # run 3 iterations by hand, checkpoint, reload, resume via the planner
    system = get_system(cfg.system)
    grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
    obstacles, _ = sc.padded_obstacles(cfg.max_obstacles)
    s0 = init_pathless_state(cfg, grid, jnp.asarray(sc.init),
                             jax.random.key(6))
    cfg3 = cfg.replace(num_iterations=3, keep_frontier_on_stall=True)
    mid = kgmt_run_pathless(cfg3, system, grid, jnp.asarray(sc.goal),
                            jnp.asarray(obstacles), s0)
    # pad metric arrays back to the full budget for the resumed run
    pad = cfg.num_iterations - cfg3.num_iterations
    mid = mid._replace(
        m_frontier_size=jnp.pad(mid.m_frontier_size, (0, pad)),
        m_valid=jnp.pad(mid.m_valid, (0, pad)),
        m_accepted=jnp.pad(mid.m_accepted, (0, pad)),
        m_tree_size=jnp.pad(mid.m_tree_size, (0, pad)))
    p = tmp_path / "pathless_ckpt.npz"
    save_checkpoint(mid, p)
    restored = load_checkpoint(p)
    assert isinstance(restored, PathlessState)
    resumed = planner.resume(restored, sc)
    assert resumed.solved == full.solved
    assert resumed.cost == full.cost  # bitwise: exact resume incl. RNG
    assert resumed.iterations == full.iterations
