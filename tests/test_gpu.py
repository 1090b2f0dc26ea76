"""Claims that only the card can check: the compiled Triton kernel against
XLA's rollout, and the bitwise equalities the CPU suite asserts (pathless
vs tree mode, one-hot permutation vs argsort, partitioned streaming pools),
re-asserted where contractions may run in TF32 and sums in another order.
They skip without a GPU; ``chip_smoke.py`` runs the same claims at full
width.

    python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudasbmp_jax.config import KGMTConfig, Scenario
from cudasbmp_jax.ops.rollout import rollout_batch
from cudasbmp_jax.ops.rollout_pallas import rollout_pallas
from cudasbmp_jax.planners.kgmt import KGMT
from cudasbmp_jax.systems.registry import get_system

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dense", [False, True], ids=["demo", "dense24"])
def test_kernel_matches_xla_on_gpu(gpu, dense):
    system = get_system("bicycle")
    sc = Scenario.dense(24) if dense else Scenario.demo()
    obstacles = jnp.asarray(sc.padded_obstacles(32)[0])
    B = 4096
    x0 = jax.random.uniform(jax.random.key(0), (B, 4), minval=1.0,
                            maxval=19.0).at[:, 2:].set(0.0)
    c = system.control_spec.sample(jax.random.key(1), (B,))
    rx, rv = rollout_batch(system, x0, c, 10, obstacles, 20.0, 20.0)
    kx, kv = rollout_pallas(system, x0, c, obstacles, num_disc=10,
                            width=20.0, height=20.0)
    rv, kv = np.asarray(rv), np.asarray(kv)
    assert (rv != kv).mean() <= 1e-4
    both = rv & kv
    np.testing.assert_allclose(np.asarray(kx)[both], np.asarray(rx)[both],
                               atol=1e-3)


def test_pathless_matches_tree_mode_on_gpu(gpu):
    cfg = KGMTConfig()
    sc = Scenario.demo()
    tree = KGMT(cfg).plan(sc)
    pathless = KGMT(cfg.replace(need_path=False)).plan(sc)
    assert tree.solved
    assert (pathless.solved, pathless.cost, pathless.iterations) == (
        tree.solved, tree.cost, tree.iterations)


def test_arena_permutation_arms_equal_on_gpu(gpu):
    from cudasbmp_jax.parallel.batch_kgmt import ArenaMultiQueryPlanner

    cfg = KGMTConfig(rollouts_per_iter=128, num_iterations=100,
                     adaptive_waves=False)
    sc = Scenario.demo()
    B = 32
    inits = np.tile(sc.init, (B, 1))
    goals = np.tile(sc.goal, (B, 1))
    obstacles = sc.padded_obstacles(cfg.max_obstacles)[0]
    out = []
    for one_hot in (True, False):
        out.append(ArenaMultiQueryPlanner(cfg, auto_capacity=True,
                                          one_hot_permute=one_hot)
                   .plan_batch(inits, goals, obstacles, seed=5))
    assert out[0].solved.any()
    for f in ("solved", "costs", "iterations", "paths"):
        np.testing.assert_array_equal(getattr(out[0], f), getattr(out[1], f))


def test_streaming_partitions_equal_on_gpu(gpu):
    from cudasbmp_jax.parallel.streaming_mc import StreamingMonteCarloPlanner

    cfg = KGMTConfig(rollouts_per_iter=128, num_iterations=60,
                     adaptive_waves=False)
    smc = StreamingMonteCarloPlanner(cfg, pool=64)
    whole = smc.run(128, seed=2)
    parts = [smc.run(64, seed=2, id_lo=lo) for lo in (0, 64)]
    np.testing.assert_array_equal(
        whole.costs, np.concatenate([p.costs for p in parts]))
    np.testing.assert_array_equal(
        whole.iters, np.concatenate([p.iters for p in parts]))
