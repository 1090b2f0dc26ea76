from cudasbmp_jax.io.csv import (
    load_scenario,
    read_obstacles_csv,
    read_sample_csv,
    write_artifacts,
    write_csv,
)
from cudasbmp_jax.io.checkpoint import save_checkpoint, load_checkpoint

__all__ = [
    "load_scenario",
    "read_obstacles_csv",
    "read_sample_csv",
    "write_artifacts",
    "write_csv",
    "save_checkpoint",
    "load_checkpoint",
]
