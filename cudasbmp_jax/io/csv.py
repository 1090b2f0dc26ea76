"""Scenario CSV IO and artifact dumps.

Implements the reference's IO layer (src/helper/helper.cu) in batched form:

- ``read_obstacles_csv`` reads the ``xmin,ymin,xmax,ymax``-per-row format of
  ``configurations/obstacles/obstacles.csv`` (readObstaclesFromCSV,
  helper.cu:11-34).
- ``load_scenario`` honors the FULL ``configurations/`` directory — init,
  goal, obstacles, numR1, numR2 — which the reference demo ignores in favor of
  hardcoded values (demos/main.cu:22-46 vs configurations/; SURVEY.md §2.4.10).
- ``write_artifacts`` dumps the planner state as the same 13 CSV files
  KGMT::plan writes (samples.csv, parentRelations.csv, G.csv, R1*.csv,
  R2*.csv — KGMT.cu:299-311), so the reference's offline analysis /
  visualization workflow applies unchanged.

A native C++ fast path for bulk CSV formatting lives in
``cudasbmp_jax.io.native`` and is used automatically when available.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from cudasbmp_jax.config import SAMPLE_DIM, KGMTConfig, Scenario


def read_sample_csv(path: str | os.PathLike) -> np.ndarray:
    """Read a single 7-float sample row (configurations/init|goal format)."""
    row = np.loadtxt(path, delimiter=",", dtype=np.float32).reshape(-1)
    out = np.zeros(SAMPLE_DIM, np.float32)
    out[: min(len(row), SAMPLE_DIM)] = row[:SAMPLE_DIM]
    return out


def read_obstacles_csv(path: str | os.PathLike) -> np.ndarray:
    """Read obstacle AABBs, one ``xmin,ymin,xmax,ymax`` row each
    (helper.cu:11-34 semantics: every comma-separated value in file order,
    4 per obstacle)."""
    try:
        from cudasbmp_jax.io.native import read_csv_native

        vals = read_csv_native(str(path))
        if vals is not None:
            return vals.astype(np.float32).reshape(-1, 4)
    except (FileNotFoundError, ValueError):
        raise
    except Exception:
        pass
    rows = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    return rows.reshape(-1, 4)


def _read_scalar_csv(path: Path) -> int | None:
    """First value of a one-number CSV; None when the file is absent (so
    callers can tell 'directory specifies a grid' from 'no opinion')."""
    if not path.exists():
        return None
    txt = path.read_text().strip().split(",")[0].strip()
    return int(float(txt)) if txt else None


def load_scenario(config_dir: str | os.PathLike) -> tuple[Scenario, dict]:
    """Load a full scenario from a ``configurations/``-layout directory.

    Returns (scenario, grid_params) where grid_params carries numR1/numR2
    values when the corresponding CSVs exist (the reference stores N in
    numR1/numR1.csv and n in R2/numR2.csv) and None when they don't — absent
    files must not override a config file's grid settings.
    """
    d = Path(config_dir)
    scenario = Scenario(
        init=read_sample_csv(d / "init" / "init.csv"),
        goal=read_sample_csv(d / "goal" / "goal.csv"),
        obstacles=read_obstacles_csv(d / "obstacles" / "obstacles.csv"),
    )
    grid_params = {
        "N": _read_scalar_csv(d / "numR1" / "numR1.csv"),
        "n": _read_scalar_csv(d / "R2" / "numR2.csv"),
    }
    return scenario, grid_params


def write_csv(array: np.ndarray, path: str | os.PathLike, cols: int = 1) -> None:
    """Write an array as CSV with ``cols`` values per row — the layout of
    copyAndWriteVectorToCSV (helper.cuh:53-79). Uses the native C++ writer
    when built, else numpy."""
    arr = np.asarray(array).reshape(-1, cols)
    try:
        from cudasbmp_jax.io.native import write_csv_native

        if write_csv_native(arr.astype(np.float64), str(path)):
            return
    except Exception:
        pass
    np.savetxt(path, arr, delimiter=",", fmt="%.9g")


# The exact artifact set KGMT::plan dumps (KGMT.cu:299-311), name for name.
REFERENCE_ARTIFACT_NAMES = frozenset({
    "samples.csv", "unexploredSamples.csv", "parentRelations.csv",
    "uParentIdx.csv", "G.csv", "R2Avail.csv", "R1Avail.csv", "R1Valid.csv",
    "R2Valid.csv", "R1Invalid.csv", "R2Invalid.csv", "R1Score.csv", "R1.csv",
})


def write_artifacts(state, config: KGMTConfig, out_dir: str | os.PathLike,
                    extras: bool = False) -> list[str]:
    """Dump the reference's 13 artifact CSVs (KGMT.cu:299-311), exactly those
    names. The staging buffer (unexploredSamples/uParentIdx — the most recent
    wave's rollouts) is carried in the state like the reference's device
    vectors, just sized [rollouts_per_iter] instead of [maxTreeSize].
    ``extras=True`` adds two beyond-reference dumps (R2.csv cell totals,
    costs.csv) that our viz tooling reads."""
    from cudasbmp_jax.planners.kgmt import frontier_mask  # lazy: no cycle

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    nr1 = config.num_r1
    g_mask = np.asarray(
        frontier_mask(state, config.max_tree_size)
    ).astype(np.int32)
    dumps = [
        ("samples.csv", np.asarray(state.tree_samples), SAMPLE_DIM),
        ("unexploredSamples.csv", np.asarray(state.u_samples), SAMPLE_DIM),
        ("parentRelations.csv", np.asarray(state.tree_parent), 1),
        ("uParentIdx.csv", np.asarray(state.u_parent), 1),
        ("G.csv", g_mask, 1),
        ("R2Avail.csv", np.asarray(state.r2_avail), 1),
        ("R1Avail.csv", np.asarray(state.r1_avail), 1),
        ("R1Valid.csv", np.asarray(state.r1_valid), 1),
        ("R2Valid.csv", np.asarray(state.r2_valid), 1),
        ("R1Invalid.csv", np.asarray(state.r1_invalid), 1),
        ("R2Invalid.csv", np.asarray(state.r2_invalid), 1),
        ("R1Score.csv", np.asarray(state.r1_score), 1),
        ("R1.csv", np.asarray(state.r1_total), 1),
    ]
    assert {n for n, _, _ in dumps} == REFERENCE_ARTIFACT_NAMES
    if extras:
        dumps += [
            ("R2.csv", np.asarray(state.r2_total), 1),
            ("costs.csv", np.asarray(state.costs), 1),
        ]
    written = []
    for name, arr, cols in dumps:
        assert arr.size % cols == 0, name
        assert nr1  # config consistency guard
        write_csv(arr, out / name, cols)
        written.append(str(out / name))
    return written
