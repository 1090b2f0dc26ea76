"""Smoke run of the KGMT planner on the GPU, through its public entry points.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # the four-card paths only

One card: the fused rollout kernel against the jnp reference at the
planner's widths; ``KGMT.plan`` and the ``cli demo`` entry point on the demo
and dense-24 fields (configuration ``systems/car.yaml``: bicycle, 20x20
field, N=16, n=8, 4096 rollouts per iteration, tree capacity 30000, 100
iterations) in tree and pathless mode, every path re-validated by the exact
rollout and pathless equal to tree mode; the 256-query arena at R=128 with
its one-hot permutation compared bitwise with argsort; a streaming sweep
through a 1024-slot pool.

``--multi``: the arena sharded over a flat 4-way mesh against the same
batch on one card (bitwise), streaming ``run_sharded`` over 4 cards against
the same scenario-id ranges on one card (bitwise), and ``ShardedTreePlanner``
with n_tree=4 solving the demo with a re-validated path.

Each phase prints its compile time (first call) and steady-state time
(second call). Before the last line it prints the card's name and power
limit. The last line is ``{"ok": true, "device": {...}}``; any failed check,
and any platform other than a GPU, exits nonzero without it. Weights do not
exist here; scenarios come from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from pathlib import Path

import numpy as np

CAR_YAML = str(Path(__file__).resolve().parent / "systems" / "car.yaml")

# Kernel vs reference: share of lanes whose valid flag may differ (Triton's
# and XLA's libdevice cos/sin/tan may differ in the last bit, which can flip
# a lane that grazes a boundary), and |x1| tolerance on lanes valid in both.
MAX_VALID_MISMATCH = 1e-4
X1_TOL = 1e-3
# fast_math replaces per-step trig by rotation recurrences: positions drift
# by f32 rounding, up to ~1e-2 where tan(steering) is near singular.
FAST_X1_TOL = 5e-2
FAST_MIN_AGREE = 0.99
# path re-validation: the replayed node must match the stored one (relative
# to max(1, |component|))
PATH_TOL = 1e-3
# the raw-propagation probe's width
PROBE_WIDTH = 1 << 17


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    """Call ``fn`` (which must wait for its device work) twice: (second
    result, compile-and-first-run seconds, steady-state seconds)."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, first, time.perf_counter() - t0


def revalidate_path(system, cfg, path, goal, obstacles) -> None:
    """Replay every edge of a root->goal path with the exact jnp rollout:
    each edge collision-free, each replayed node equal to the stored one,
    the last node inside the goal region."""
    import jax.numpy as jnp

    from cudasbmp_jax.ops.rollout import rollout_batch

    path = np.asarray(path)
    check(len(path) >= 2, f"path has {len(path)} nodes")
    S = system.state_dim
    x1, valid = rollout_batch(system, jnp.asarray(path[:-1, :S]),
                              jnp.asarray(path[1:, S:]), cfg.num_disc,
                              jnp.asarray(obstacles), cfg.width, cfg.height)
    valid = np.asarray(valid)
    # relative where a component is large: theta grows without bound when
    # tan(steering) is near singular, and its ulp with it
    ref = path[1:, :S]
    err = float((np.abs(np.asarray(x1) - ref)
                 / np.maximum(1.0, np.abs(ref))).max())
    check(valid.all(), f"{int((~valid).sum())} path edges collide on replay")
    check(err <= PATH_TOL, f"replayed path drifts by {err}")
    d = float(np.hypot(*(path[-1, :2] - np.asarray(goal)[:2])))
    check(d < cfg.goal_threshold, f"path ends {d} from the goal")


def phase_kernel(car) -> None:
    """The fused kernel against the jnp reference at the planner's wave
    width (4096) and the throughput probe's (2^17), on both fields, plus
    fast_math and the vmapped per-problem form the arena uses."""
    import jax
    import jax.numpy as jnp

    from cudasbmp_jax.config import Scenario
    from cudasbmp_jax.ops.rollout import rollout_batch
    from cudasbmp_jax.ops.rollout_pallas import rollout_pallas
    from cudasbmp_jax.systems.registry import get_system

    system = get_system("bicycle")
    kw = dict(num_disc=car.num_disc, width=car.width, height=car.height)
    for field, sc in (("demo", Scenario.demo()), ("dense24",
                                                  Scenario.dense(24))):
        obstacles = jnp.asarray(sc.padded_obstacles(car.max_obstacles)[0])
        for B in (car.rollouts_per_iter, PROBE_WIDTH):
            x0 = jax.random.uniform(jax.random.key(B), (B, 4), minval=1.0,
                                    maxval=19.0).at[:, 2:].set(0.0)
            c = system.control_spec.sample(jax.random.key(1), (B,))
            ref = jax.jit(lambda x, u: rollout_batch(
                system, x, u, car.num_disc, obstacles, car.width,
                car.height))
            ker = jax.jit(lambda x, u: rollout_pallas(
                system, x, u, obstacles, **kw))
            (rx, rv), _, t_ref = timed(
                lambda: jax.block_until_ready(ref(x0, c)))
            (kx, kv), first, t_ker = timed(
                lambda: jax.block_until_ready(ker(x0, c)))
            rx, rv, kx, kv = map(np.asarray, (rx, rv, kx, kv))
            mism = float((rv != kv).mean())
            both = rv & kv
            err = float(np.abs(rx - kx)[both].max())
            log(f"kernel {field} K={obstacles.shape[0]} B={B}: valid "
                f"mismatch {mism}, max |x1| diff {err}; kernel compile "
                f"{first:.2f} s, {t_ker * 1e6:.1f} us/call vs jnp "
                f"{t_ref * 1e6:.1f} us/call (one dispatch each)")
            check(mism <= MAX_VALID_MISMATCH, f"valid mismatch {mism}")
            check(err <= X1_TOL, f"x1 diff {err}")
            check(0.0 < rv.mean() < 1.0, "field kills no or all rollouts")
            fx, fv = map(np.asarray, jax.jit(lambda x, u: rollout_pallas(
                system, x, u, obstacles, fast_math=True, **kw))(x0, c))
            agree = float((fv == rv).mean())
            ferr = float(np.abs(fx - rx)[fv & rv].max())
            log(f"  fast_math: valid agreement {agree}, max |x1| diff {ferr}")
            check(agree >= FAST_MIN_AGREE, f"fast_math agreement {agree}")
            check(ferr <= FAST_X1_TOL, f"fast_math x1 diff {ferr}")
    # per-problem obstacle sets: vmap of the kernel call (arena, streaming)
    B, R = 256, 128
    obs = np.stack([Scenario.dense(24, seed=s).padded_obstacles(
        car.max_obstacles)[0] for s in range(B)])
    x0 = jax.random.uniform(jax.random.key(3), (B, R, 4), minval=1.0,
                            maxval=19.0).at[..., 2:].set(0.0)
    c = system.control_spec.sample(jax.random.key(4), (B, R))
    rv = np.asarray(jax.jit(jax.vmap(lambda x, u, o: rollout_batch(
        system, x, u, car.num_disc, o, car.width, car.height)[1]))(
            x0, c, obs))
    kv = np.asarray(jax.jit(jax.vmap(lambda x, u, o: rollout_pallas(
        system, x, u, o, **kw)[1]))(x0, c, obs))
    mism = float((rv != kv).mean())
    log(f"kernel vmapped over {B} obstacle sets x {R} lanes: valid "
        f"mismatch {mism}")
    check(mism <= MAX_VALID_MISMATCH, f"vmapped valid mismatch {mism}")


def phase_solves(car) -> None:
    """KGMT.plan in tree and pathless mode on both fields, and the CLI's
    demo entry point, all on the auto backend (the kernel on a GPU)."""
    from cudasbmp_jax import cli
    from cudasbmp_jax.config import Scenario
    from cudasbmp_jax.planners.kgmt import KGMT

    for field, sc in (("demo", Scenario.demo()), ("dense24",
                                                  Scenario.dense(24))):
        tree_planner = KGMT(car)
        tree, first, steady = timed(lambda: tree_planner.plan(sc))
        check(tree.solved, f"{field}: tree mode did not solve")
        revalidate_path(tree_planner.system, car, tree.path, sc.goal,
                        sc.obstacles)
        log(f"solve {field} tree: cost {tree.cost:.4f}, {tree.iterations} "
            f"iterations, tree {tree.tree_size}, path {len(tree.path)} "
            f"nodes re-validated; compile+first {first:.2f} s, steady "
            f"{steady * 1e3:.2f} ms")
        pl_planner = KGMT(car.replace(need_path=False))
        pathless, first, steady = timed(lambda: pl_planner.plan(sc))
        got = (pathless.solved, pathless.cost, pathless.iterations)
        want = (tree.solved, tree.cost, tree.iterations)
        check(got == want, f"{field}: pathless {got} != tree {want}")
        log(f"solve {field} pathless: equal to tree mode; compile+first "
            f"{first:.2f} s, steady {steady * 1e3:.2f} ms")
    t0 = time.perf_counter()
    rc = cli.main(["demo", "--config", CAR_YAML])
    check(rc == 0, f"cli demo exited {rc}")
    log(f"cli demo: exit 0 in {time.perf_counter() - t0:.2f} s")


def _arena_batch(batch: int, max_obstacles: int):
    from cudasbmp_jax.config import Scenario

    sc = Scenario.demo()
    rng = np.random.default_rng(0)
    goals = np.tile(sc.goal, (batch, 1)).astype(np.float32)
    goals[:, :2] += rng.uniform(-1.0, 1.0, (batch, 2)).astype(np.float32)
    return (np.tile(sc.init, (batch, 1)).astype(np.float32), goals,
            sc.padded_obstacles(max_obstacles)[0])


def _arena_cfg(car):
    return car.replace(rollouts_per_iter=128, num_iterations=150,
                       adaptive_waves=False)


def _assert_same_batch(a, b, what: str) -> None:
    for f in ("solved", "costs", "iterations", "paths", "path_lengths"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")


def phase_arena(car) -> None:
    """ArenaMultiQueryPlanner.plan_batch: 256 queries at R=128, and the
    one-hot permutation arm against argsort + gather, bitwise."""
    from cudasbmp_jax.parallel.batch_kgmt import ArenaMultiQueryPlanner
    from cudasbmp_jax.systems.registry import get_system

    cfg = _arena_cfg(car)
    inits, goals, obstacles = _arena_batch(256, cfg.max_obstacles)
    results = {}
    for arm, one_hot in (("argsort", False), ("onehot", True)):
        planner = ArenaMultiQueryPlanner(cfg, auto_capacity=True,
                                         one_hot_permute=one_hot)
        t0 = time.perf_counter()
        planner.plan_batch(inits, goals, obstacles, seed=1)
        first = time.perf_counter() - t0
        res = planner.plan_batch(inits, goals, obstacles, seed=2)
        results[arm] = res
        q = np.quantile(res.costs[res.solved], [.1, .5, .9])
        log(f"arena {arm} B=256 R=128: solve rate {res.solved.mean():.4f}, "
            f"cost p10/p50/p90 {q.round(3).tolist()}, compile+first "
            f"{first:.2f} s, steady {res.wall_time_s:.4f} s "
            f"({res.solves_per_sec:.1f} solves/s)")
    res = results["argsort"]
    check(res.solved.mean() >= 0.9, f"arena solve rate {res.solved.mean()}")
    _assert_same_batch(results["onehot"], res, "one-hot vs argsort")
    system = get_system(cfg.system)
    for b in np.flatnonzero(res.solved)[:8]:
        revalidate_path(system, cfg,
                        res.paths[b][:res.path_lengths[b]], goals[b],
                        obstacles)
    log("arena: one-hot permutation bitwise equal to argsort; 8 paths "
        "re-validated")


def phase_streaming(car) -> None:
    """StreamingMonteCarloPlanner.run: 4096 random scenarios through a
    1024-slot pool."""
    from cudasbmp_jax.parallel.streaming_mc import StreamingMonteCarloPlanner

    smc = StreamingMonteCarloPlanner(_arena_cfg(car), pool=1024)
    t0 = time.perf_counter()
    smc.run(4096, seed=0)
    first = time.perf_counter() - t0
    s = smc.run(4096, seed=1)
    log(f"streaming 4096 scenarios / 1024 slots: solve rate "
        f"{s.solve_rate:.4f}, cost quantiles {s.cost_quantiles}, "
        f"compile+first {first:.2f} s, steady {s.wall_time_s:.4f} s "
        f"({s.solves_per_sec:.1f} solves/s)")
    check(s.solve_rate >= 0.9, f"streaming solve rate {s.solve_rate}")
    solved = np.isfinite(s.costs)
    check(bool((s.costs[solved] > 0).all()), "non-positive solved cost")


def phase_multi(car) -> None:
    """The four-card paths, each compared with one card."""
    import jax

    from cudasbmp_jax.config import Scenario
    from cudasbmp_jax.parallel import (
        ArenaMultiQueryPlanner,
        ShardedTreePlanner,
        StreamingMonteCarloPlanner,
        make_planner_mesh,
    )

    n = len(jax.devices())
    check(n == 4, f"--multi needs 4 cards, JAX sees {n}")
    flat = make_planner_mesh()  # 4-way 'scenario' axis
    cfg = _arena_cfg(car)
    inits, goals, obstacles = _arena_batch(256, cfg.max_obstacles)
    one = ArenaMultiQueryPlanner(cfg, auto_capacity=True)
    sharded = ArenaMultiQueryPlanner(cfg, mesh=flat, auto_capacity=True)
    for name, p in (("one card", one), ("4-way mesh", sharded)):
        t0 = time.perf_counter()
        p.plan_batch(inits, goals, obstacles, seed=1)
        first = time.perf_counter() - t0
        res = p.plan_batch(inits, goals, obstacles, seed=2)
        log(f"arena {name}: solve rate {res.solved.mean():.4f}, "
            f"compile+first {first:.2f} s, steady {res.wall_time_s:.4f} s")
        if p is one:
            ref = res
    _assert_same_batch(res, ref, "arena 4-way mesh vs one card")
    log("arena: 4-way sharded batch bitwise equal to one card")

    total, per = 4096, 1024
    smc = StreamingMonteCarloPlanner(cfg, pool=1024)
    smc.run_sharded(total, mesh=flat, seed=3)
    t0 = time.perf_counter()
    s4 = smc.run_sharded(total, mesh=flat, seed=3)
    steady = time.perf_counter() - t0
    costs, iters = [], []
    for k in range(4):
        part = smc.run(per, seed=3, id_lo=k * per)
        costs.append(part.costs)
        iters.append(part.iters)
    check(np.array_equal(s4.costs, np.concatenate(costs)),
          "streaming run_sharded costs differ from one card")
    check(np.array_equal(s4.iters, np.concatenate(iters)),
          "streaming run_sharded iterations differ from one card")
    log(f"streaming run_sharded 4 x {per}: solve rate {s4.solve_rate:.4f}, "
        f"steady {steady:.4f} s ({total / steady:.1f} solves/s); bitwise "
        f"equal to the same id ranges on one card")

    tree = ShardedTreePlanner(car, mesh=make_planner_mesh(n_scenario=1,
                                                          n_tree=4))
    sc = Scenario.demo()
    t0 = time.perf_counter()
    tree.plan(sc)
    first = time.perf_counter() - t0
    r = tree.plan(sc)
    check(r.solved, "sharded tree did not solve the demo")
    revalidate_path(tree.system, car, r.path, sc.goal, sc.obstacles)
    log(f"sharded tree n_tree=4: cost {r.cost:.4f}, {r.iterations} "
        f"iterations, path {len(r.path)} nodes re-validated, shards "
        f"{sorted(set(r.path_shards.tolist()))}; compile+first "
        f"{first:.2f} s, steady {r.wall_time_s:.4f} s")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card paths")
    args = parser.parse_args(argv)

    import jax

    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    car = KGMTConfig.from_file(CAR_YAML)
    phases = ([("multi", phase_multi)] if args.multi else
              [("kernel", phase_kernel), ("solves", phase_solves),
               ("arena", phase_arena), ("streaming", phase_streaming)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(car)
        except Exception as e:  # noqa: BLE001 — report, run the rest, fail
            failed.append(name)
            log(f"PHASE {name} FAILED: {e!r}")
            continue
        log(f"PHASE {name} passed in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    if failed or smi.returncode != 0:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
