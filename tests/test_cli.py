"""CLI tests: the demo driver (demos/main.cu analog), configurations/ mode,
probes, artifact dumps + viz."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def run_cli(*args, timeout=420):
    """Run the CLI in a subprocess on the forced-CPU platform."""
    code = (
        "import os;"
        "os.environ['XLA_FLAGS']=os.environ.get('XLA_FLAGS','')"
        "+' --xla_force_host_platform_device_count=8';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from cudasbmp_jax.cli import main;"
        f"import sys; sys.exit(main({list(args)!r}))"
    )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, cwd=REPO,
    )


def test_cli_flag_overrides_config_file_even_at_default_value(tmp_path):
    """An explicit flag must beat --config even when its value equals the
    dataclass default (e.g. --seed 0 over a file's seed: 42)."""
    from cudasbmp_jax.cli import _config_from_args, main  # noqa: F401
    import argparse

    from cudasbmp_jax.config import KGMTConfig

    cfg_file = tmp_path / "cfg.json"
    KGMTConfig(seed=42, N=8, n=4).to_file(str(cfg_file))
    parser = argparse.ArgumentParser()
    from cudasbmp_jax.cli import _add_config_args

    _add_config_args(parser)
    args = parser.parse_args(["--config", str(cfg_file), "--seed", "0"])
    cfg = _config_from_args(args)
    assert cfg.seed == 0  # explicit flag wins
    assert cfg.N == 8 and cfg.n == 4  # unset flags defer to the file


@pytest.mark.slow
def test_cli_demo_solves(tmp_path):
    r = run_cli(
        "demo", "--max-tree-size", "16384", "--rollouts-per-iter", "2048",
        "--out-dir", str(tmp_path),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    # reference print parity lines (KGMT.cu:100,295-296)
    assert "Goal: " in r.stdout
    assert "time inside KGMT is " in r.stdout
    assert "Iteration " in r.stdout and "Tree size " in r.stdout
    assert (tmp_path / "samples.csv").exists()
    assert (tmp_path / "R1Score.csv").exists()


@pytest.mark.slow
def test_cli_plan_configurations(tmp_path):
    cfg_dir = tmp_path / "configurations"
    for sub, content in [
        ("init/init.csv", "1.0,1.0,0,0,0,0,0"),
        ("goal/goal.csv", "9.0,9.0,0,0,0,0,0"),
        ("obstacles/obstacles.csv", "2,2,4,4\n7,2,9,5\n"),
        ("numR1/numR1.csv", "16"),
        ("R2/numR2.csv", "8"),
    ]:
        p = cfg_dir / sub
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    r = run_cli(
        "plan", "--configurations", str(cfg_dir),
        "--max-tree-size", "8192", "--rollouts-per-iter", "1024",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"solved": true' in r.stdout


@pytest.mark.slow
def test_cli_probe():
    r = run_cli("probe", "--planner", "costprop", "--width", "16384")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Kernel execution time:" in r.stdout  # NaivePlanner.cu:129 parity
    assert "Tree size: 16384" in r.stdout
    line = [l for l in r.stdout.splitlines() if l.startswith("{")][-1]
    assert json.loads(line)["rollouts_per_sec"] > 0


def test_cli_help_all_subcommands():
    """argparse expands help strings with %-formatting; a stray '%' in any
    flag's help crashes --help (regression: the fast-math help text)."""
    for sub in ("demo", "plan", "probe", "viz", "record", "profile",
                "multi", "sweep"):
        r = run_cli(sub, "--help")
        assert r.returncode == 0, f"{sub} --help: {r.stderr[-500:]}"


@pytest.mark.slow
def test_cli_footprint_flag():
    r = run_cli("demo", "--footprint-width", "0.5",
                "--max-tree-size", "16384", "--rollouts-per-iter", "2048")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "time inside KGMT is" in r.stdout


@pytest.mark.slow
def test_cli_multi():
    r = run_cli("multi", "--batch", "8", "--max-tree-size", "16384",
                "--rollouts-per-iter", "2048")
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"solve_rate"' in r.stdout


@pytest.mark.slow
def test_cli_multi_arena():
    """--impl arena routes through the scatter-free batched planner."""
    r = run_cli("multi", "--impl", "arena", "--batch", "8",
                "--max-tree-size", str(512 * 41), "--rollouts-per-iter",
                "512", "--num-iterations", "40", "--rollout-backend", "jnp",
                "--goal-jitter", "0.5")
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"solve_rate"' in r.stdout


@pytest.mark.slow
def test_cli_sweep():
    r = run_cli("sweep", "--scenarios", "8", "--obstacles", "5",
                "--max-tree-size", "4096", "--rollouts-per-iter", "512",
                "--num-iterations", "40")
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"solves_per_sec"' in r.stdout


@pytest.mark.slow
def test_cli_sweep_arena():
    r = run_cli("sweep", "--impl", "arena", "--scenarios", "8",
                "--obstacles", "5", "--max-tree-size", "15872",
                "--rollouts-per-iter", "512", "--num-iterations", "30",
                "--rollout-backend", "jnp")
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"solves_per_sec"' in r.stdout


@pytest.mark.slow
def test_cli_sharded_with_checkpointing(tmp_path):
    r = run_cli("sharded", "--num-iterations", "60", "--max-tree-size",
                "2048", "--rollouts-per-iter", "512", "--no-adaptive-waves",
                "--checkpoint-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"solved": true' in r.stdout
    assert list(tmp_path.glob("sharded_checkpoint_*.npz"))


def test_cli_demo_pathless(capsys):
    """--no-need-path solves without a tree and rejects path-dependent
    flags."""
    from cudasbmp_jax.cli import main

    rc = main(["demo", "--no-need-path", "--num-iterations", "60",
               "--max-tree-size", "8192", "--rollouts-per-iter", "512",
               "--no-adaptive-waves"])
    out = capsys.readouterr().out
    assert rc == 0
    assert '"path_length": 0' in out
    rc = main(["demo", "--no-need-path", "--shortcut"])
    assert rc == 2
    assert "incompatible" in capsys.readouterr().out
