"""Device-mesh helpers — the multi-chip layer the reference never had
(SURVEY.md §2.3 P7/P8: the reference is single-process single-GPU; its only
"communication" is cudaMemcpy).

Two mesh axes cover the BASELINE.json scale-out configs:
- ``scenario``: data-parallel independent planning problems (multi-query
  batches, Monte-Carlo sweeps) — no cross-talk except result reduction.
- ``tree``: one logical planner whose rollout work and tree storage are
  sharded; region statistics / termination flags all-reduce over this axis
  each iteration (ShardedTreePlanner).

Within one host every card reaches every other over NVLink at the same
rate, so the mesh's shape follows the algorithm alone: any 4 cards form a
4x1 or 1x4 mesh equally well. Across hosts the network is the slow link, so
``scenario`` is the outermost axis and spans hosts first: the chatty ``tree``
axis stays inside one host's NVLink.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def device_count() -> int:
    return len(jax.devices())


def make_planner_mesh(n_scenario: int | None = None, n_tree: int = 1,
                      ) -> Mesh:
    """Create a ('scenario', 'tree') mesh. Defaults to all devices on the
    scenario axis. ``scenario`` is outermost so cross-host traffic stays on
    the embarrassingly parallel axis."""
    n_dev = device_count()
    if n_scenario is None:
        n_scenario = n_dev // n_tree
    if n_scenario * n_tree != n_dev:
        raise ValueError(
            f"mesh {n_scenario}x{n_tree} != device count {n_dev}"
        )
    # Auto axis types: let XLA propagate shardings (the planner's scatters
    # have no natural explicit annotation; Explicit mode would demand one per
    # .at[].set site).
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((n_scenario, n_tree), ("scenario", "tree"),
                         axis_types=auto)


def maybe_initialize_distributed() -> None:
    """Initialize jax.distributed when launched under a multi-process
    coordinator (JAX_COORDINATOR_ADDRESS env); no-op otherwise. This is the
    entire NCCL/MPI-equivalent bootstrap — XLA collectives handle transport
    (SURVEY.md §5 'distributed communication backend')."""
    import os

    if os.environ.get("JAX_COORDINATOR_ADDRESS") and jax.process_count() == 1:
        jax.distributed.initialize()
