"""Benchmark harness: the planner's cells on one GPU.

Headline metric: **valid propagations/sec** — collision-checked
``num_disc``-step kinematic-bicycle rollouts per second through the rollout
path the planner uses, on the demo workload's obstacle set (the reference's
CostPropPlanner throughput probe, upgraded to include collision checking as
BASELINE.md specifies). The other phases are time to first solution (wall
and device, tree and pathless, demo and dense-24 fields), the multi-query
arena at R=128 and R=1024, static and streaming Monte-Carlo, and two A/Bs:
the fused rollout kernel against XLA's version, and the arena's one-hot
permutation against argsort + gather.

Every phase prints one JSON line naming the device; the last line is the
headline. The bench refuses to run without a GPU, and exits nonzero if any
phase failed. ``--phases a,b`` runs a subset. vs_baseline = value / (10x the
single-process CPU rate), measured in a child process that forces the CPU
before JAX starts and never opens the card.

    python bench.py [--phases thr,dev_tts,...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CPU_CACHE = REPO / ".bench_cpu_baseline.json"

# Rollout batch for the throughput probe: large enough to fill the card.
BATCH = 1 << 17
NUM_DISC = 10
REPEATS = 20


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"
    return out.stdout.strip()


def _median_wall(fn, *args, trials: int = 5) -> float:
    import jax

    walls = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _field(dense: bool):
    from cudasbmp_jax.config import Scenario

    return Scenario.dense(24) if dense else Scenario.demo()


def _rollout_fn(backend: str, system, obstacles, fast_math: bool = False,
                footprint=None):
    """(x0, controls) -> (x1, valid) for one rollout implementation."""
    from cudasbmp_jax.ops.rollout import rollout_batch
    from cudasbmp_jax.ops.rollout_pallas import rollout_pallas

    if backend == "pallas":
        return lambda x0, c: rollout_pallas(
            system, x0, c, obstacles, num_disc=NUM_DISC, width=20.0,
            height=20.0, fast_math=fast_math, footprint=footprint)
    return lambda x0, c: rollout_batch(system, x0, c, NUM_DISC, obstacles,
                                       20.0, 20.0, footprint=footprint)


def _start_states(batch: int, state_dim: int):
    """Starts spread over free space, like a mid-solve frontier."""
    import jax

    key = jax.random.key(0)
    x0 = jax.random.uniform(key, (batch, state_dim), minval=1.0, maxval=19.0)
    return x0.at[:, 2:].set(0.0)


def measure_prop_throughput(batch: int = BATCH, repeats: int = REPEATS,
                            backend: str = "jnp", dense: bool = False,
                            fast_math: bool = False) -> dict:
    """Valid propagations/sec on the default device: ``repeats`` waves of
    ``batch`` rollouts inside one dispatch. backend: 'jnp' (XLA) or 'pallas'
    (fused kernel); dense=True swaps in the 24-obstacle field."""
    import jax
    import jax.numpy as jnp

    from cudasbmp_jax.systems.registry import get_system

    system = get_system("bicycle")
    obstacles = jnp.asarray(_field(dense).obstacles)
    roll = _rollout_fn(backend, system, obstacles, fast_math=fast_math)

    @jax.jit
    def probe(key, x0):
        def body(total, i):
            controls = system.control_spec.sample(jax.random.fold_in(key, i),
                                                  (batch,))
            _, valid = roll(x0, controls)
            return total + valid.sum(dtype=jnp.int32), None

        total, _ = jax.lax.scan(body, jnp.int32(0),
                                jnp.arange(repeats, dtype=jnp.int32))
        return total

    x0 = _start_states(batch, system.state_dim)
    key = jax.random.key(1)
    t0 = time.perf_counter()
    int(probe(key, x0))
    compile_s = time.perf_counter() - t0
    dt = _median_wall(probe, key, x0)
    valid = int(probe(key, x0))
    return {
        "backend": backend, "dense": dense, "fast_math": fast_math,
        "batch": batch, "repeats": repeats,
        "rollouts_per_sec": batch * repeats / dt,
        "valid_per_sec": valid / dt,
        "seconds": dt, "compile_s": compile_s,
    }


def measure_rollout_ab(batches=(4096, 1 << 17)) -> dict:
    """The fused kernel against XLA's rollout, per call: B lanes x K boxes
    (demo K=5, dense K=24, and dense with the oriented footprint), each
    timed as n calls inside one dispatch. Parity columns, from the last
    call: share of lanes whose valid flag differs from the jnp scan, and the
    largest |x1| difference among lanes valid in both."""
    import jax
    import jax.numpy as jnp

    from cudasbmp_jax.systems.registry import get_system

    system = get_system("bicycle")
    variants = (("jnp", "jnp"), ("pallas", "pallas"))
    fields = (("K5", False, None), ("K24", True, None),
              ("K24_footprint", True, (0.5, 0.25)))
    out = {}
    for batch in batches:
        n = 200 if batch <= 8192 else 20
        x0 = _start_states(batch, system.state_dim)
        controls = system.control_spec.sample(jax.random.key(2), (batch,))
        for label, dense, footprint in fields:
            obstacles = jnp.asarray(_field(dense).obstacles)
            ref = None
            cell = {}
            for name, backend in variants:
                roll = _rollout_fn(backend, system, obstacles,
                                   footprint=footprint)

                @jax.jit
                def many(x0, c, roll=roll):
                    def body(carry, i):
                        # the call depends on i, so XLA cannot hoist it
                        return roll(x0, c + i.astype(jnp.float32) * 0.0), None
                    return jax.lax.scan(body, roll(x0, c),
                                        jnp.arange(n, dtype=jnp.int32))[0]

                t0 = time.perf_counter()
                x1, valid = jax.device_get(many(x0, controls))
                compile_s = time.perf_counter() - t0
                if ref is None:
                    ref = (x1, valid)
                both = ref[1] & valid
                cell[name] = {
                    "us_per_call": _median_wall(many, x0, controls) / n * 1e6,
                    "compile_s": compile_s,
                    "valid_mismatch_frac": float((ref[1] != valid).mean()),
                    "x1_max_abs_diff": float(np.abs(ref[0] - x1)[both].max())
                    if both.any() else 0.0,
                }
            out[f"B{batch}_{label}"] = cell
    return out


def measure_time_to_solution(rollout_backend: str = "auto",
                             scenario: str = "demo", seeds: int = 20,
                             **cfg_overrides) -> dict:
    """Wall time to first solution through ``KGMT.plan`` over ``seeds``
    independent solves, with p10/p50/p90 quantiles."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.planners.kgmt import KGMT

    sc = _field(scenario == "dense24")
    planner = KGMT(KGMTConfig(rollout_backend=rollout_backend,
                              **cfg_overrides))
    t0 = time.perf_counter()
    planner.plan(sc)
    compile_s = time.perf_counter() - t0
    planner.plan(sc, seed=101)
    results = [planner.plan(sc, seed=s) for s in range(seeds)]
    solved = [r for r in results if r.solved]

    def _q(xs):
        if not xs:
            return None
        q = np.quantile(np.asarray(xs, float), [0.1, 0.5, 0.9])
        return {"p10": float(q[0]), "p50": float(q[1]), "p90": float(q[2])}

    return {
        "scenario": scenario, "rollout_backend": rollout_backend,
        "seeds": seeds, "compile_s": compile_s,
        "solve_rate": len(solved) / len(results),
        "tts_quantiles_s": _q([r.wall_time_s for r in solved]),
        "cost_quantiles": _q([r.cost for r in solved]),
        "iters_quantiles": _q([r.iterations for r in solved]),
    }


def measure_device_tts(rollout_backend: str = "auto", need_path: bool = True,
                       scenario: str = "demo", **cfg_overrides) -> dict:
    """Device time per solve: K full solves run sequentially inside one
    dispatch (lax.scan over seeds) at two K values; the slope d(wall)/dK
    removes the fixed dispatch and transfer cost. Per-seed
    (cost, iterations) come back as arrays."""
    import jax
    import jax.numpy as jnp

    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.geometry.grid import RegionGrid
    from cudasbmp_jax.planners.kgmt import kgmt_solve, kgmt_solve_pathless
    from cudasbmp_jax.systems.registry import get_system

    solve = kgmt_solve if need_path else kgmt_solve_pathless
    cfg = KGMTConfig(rollout_backend=rollout_backend, need_path=need_path,
                     **cfg_overrides)
    system = get_system(cfg.system)
    grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
    sc = _field(scenario == "dense24")
    obstacles = jnp.asarray(sc.padded_obstacles(cfg.max_obstacles)[0])
    init, goal = jnp.asarray(sc.init), jnp.asarray(sc.goal)

    k_lo, k_hi = 2, 12

    @jax.jit
    def run(key0, k):
        # k is traced, so both K values share one compiled program
        def body(i, acc):
            final = solve(cfg, system, grid, init, goal, obstacles,
                          jax.random.fold_in(key0, i))
            return (acc[0].at[i].set(final.cost_to_goal),
                    acc[1].at[i].set(final.itr))

        return jax.lax.fori_loop(0, k, body,
                                 (jnp.full(k_hi, jnp.inf, jnp.float32),
                                  jnp.zeros(k_hi, jnp.int32)))

    key = jax.random.key(42)
    t0 = time.perf_counter()
    costs, iters = jax.device_get(run(key, k_hi))
    compile_s = time.perf_counter() - t0
    t_lo = _median_wall(run, key, k_lo)
    t_hi = _median_wall(run, key, k_hi)
    solved = np.isfinite(costs)
    return {
        "scenario": scenario, "rollout_backend": rollout_backend,
        "need_path": need_path, "compile_s": compile_s,
        "tts_device_s": max(t_hi - t_lo, 0.0) / (k_hi - k_lo),
        "solve_rate": float(solved.mean()),
        "cost_p50": float(np.median(costs[solved])) if solved.any() else None,
        "iters_p50": float(np.median(iters[solved])) if solved.any()
        else None,
        "k_lo": k_lo, "k_hi": k_hi, "wall_lo_s": t_lo, "wall_hi_s": t_hi,
    }


def _demo_batch(batch: int, max_obstacles: int):
    sc = _field(False)
    obstacles, _ = sc.padded_obstacles(max_obstacles)
    return (np.tile(sc.init, (batch, 1)), np.tile(sc.goal, (batch, 1)),
            obstacles)


def _cost_q(solved, costs):
    if not np.asarray(solved).any():
        return None
    q = np.quantile(np.asarray(costs)[np.asarray(solved)], [0.1, 0.5, 0.9])
    return [float(x) for x in q]


def measure_multi_query(batch: int = 256,
                        rollouts_per_iter: int = 128) -> dict:
    """BASELINE config 4: ``batch`` demo queries planned at once by the
    arena (parallel/batch_kgmt.py). Reports solves/s with the solution-cost
    quantiles: fixed-width waves trade cost for speed against the
    reference's full per-node fan-out (KGMT.cu:151-158)."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.parallel.batch_kgmt import ArenaMultiQueryPlanner

    cfg = KGMTConfig(rollouts_per_iter=rollouts_per_iter, num_iterations=150,
                     adaptive_waves=False)
    planner = ArenaMultiQueryPlanner(cfg, auto_capacity=True)
    inits, goals, obstacles = _demo_batch(batch, cfg.max_obstacles)
    t0 = time.perf_counter()
    planner.plan_batch(inits, goals, obstacles, seed=7)
    compile_s = time.perf_counter() - t0
    res = planner.plan_batch(inits, goals, obstacles, seed=8,
                             max_extensions=1)
    return {
        "batch": batch, "rollouts_per_iter": rollouts_per_iter,
        "compile_s": compile_s,
        "solve_rate": float(res.solved.mean()),
        "solves_per_sec": res.solves_per_sec,
        "wall_time_s": res.wall_time_s,
        "cost_quantiles": _cost_q(res.solved, res.costs),
    }


def measure_permute_ab(batch: int = 256, rollouts_per_iter: int = 128,
                       rounds: int = 3) -> dict:
    """The arena's one-hot permutation matmuls against stable argsort +
    take_along_axis at R=128 (``one_hot_permute`` picks between them):
    solve wall time of each, in alternating turns, and whether the results
    are bitwise equal."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.parallel.batch_kgmt import ArenaMultiQueryPlanner

    cfg = KGMTConfig(rollouts_per_iter=rollouts_per_iter, num_iterations=150,
                     adaptive_waves=False)
    inits, goals, obstacles = _demo_batch(batch, cfg.max_obstacles)
    planners = {}
    for name, one_hot in (("onehot", True), ("argsort", False)):
        p = ArenaMultiQueryPlanner(cfg, auto_capacity=True,
                                   one_hot_permute=one_hot)
        p.plan_batch(inits, goals, obstacles, seed=3)
        planners[name] = p
    walls = {name: [] for name in planners}
    results = {}
    for r in range(rounds):
        order = ("onehot", "argsort") if r % 2 == 0 else ("argsort",
                                                          "onehot")
        for name in order:
            res = planners[name].plan_batch(inits, goals, obstacles, seed=4)
            walls[name].append(res.wall_time_s)
            results[name] = res
    a, b = results["onehot"], results["argsort"]
    equal = all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("solved", "costs", "iterations", "paths"))
    return {"batch": batch, "rollouts_per_iter": rollouts_per_iter,
            "onehot_wall_s": walls["onehot"],
            "argsort_wall_s": walls["argsort"],
            "onehot_median_s": float(np.median(walls["onehot"])),
            "argsort_median_s": float(np.median(walls["argsort"])),
            "bitwise_equal": bool(equal)}


def measure_monte_carlo(batch: int = 1024, num_obstacles: int = 8) -> dict:
    """BASELINE config 5's per-card half: ``batch`` randomized obstacle
    scenarios through the arena, per-scenario obstacle sets vmapped."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.parallel.monte_carlo import MonteCarloPlanner

    cfg = KGMTConfig(rollouts_per_iter=128, num_iterations=150,
                     adaptive_waves=False)
    mc = MonteCarloPlanner(cfg, impl="arena", auto_capacity=True)
    # the restarts build sub-planners whose shapes depend on how many
    # scenarios exhaust their budget, so the warm-up is the timed call itself
    t0 = time.perf_counter()
    mc.run(batch, seed=1, num_obstacles=num_obstacles, max_extensions=2)
    compile_s = time.perf_counter() - t0
    s = mc.run(batch, seed=1, num_obstacles=num_obstacles, max_extensions=2)
    return {
        "batch": batch, "num_obstacles": num_obstacles,
        "compile_s": compile_s, "solve_rate": s.solve_rate,
        "solves_per_sec": s.solves_per_sec, "wall_time_s": s.wall_time_s,
        "cost_quantiles": _cost_q(s.solved, s.costs),
        "num_budget_exhausted": s.num_budget_exhausted,
    }


def measure_streaming_mc(total: int = 4096, pool: int = 1024,
                         num_obstacles: int = 8) -> dict:
    """Streaming Monte-Carlo: solved slots refill with fresh scenarios on
    the device. ``total`` > ``pool`` so the pool runs full before it
    drains."""
    from cudasbmp_jax.config import KGMTConfig
    from cudasbmp_jax.parallel.streaming_mc import StreamingMonteCarloPlanner

    cfg = KGMTConfig(rollouts_per_iter=128, num_iterations=150,
                     adaptive_waves=False)
    mc = StreamingMonteCarloPlanner(cfg, pool=min(pool, total))
    t0 = time.perf_counter()
    mc.run(total, seed=0, num_obstacles=num_obstacles)
    compile_s = time.perf_counter() - t0
    s = mc.run(total, seed=1, num_obstacles=num_obstacles)
    return {
        "total_scenarios": total, "pool": mc.pool,
        "num_obstacles": num_obstacles, "compile_s": compile_s,
        "solve_rate": s.solve_rate, "solves_per_sec": s.solves_per_sec,
        "wall_time_s": s.wall_time_s, "cost_quantiles": s.cost_quantiles,
        "num_budget_exhausted": s.num_budget_exhausted,
    }


def cpu_baseline() -> float:
    """Single-process CPU valid-props/sec, measured once and cached. The
    child forces the CPU before JAX starts, so it never opens the card."""
    if CPU_CACHE.exists():
        return json.loads(CPU_CACHE.read_text())["valid_per_sec"]
    code = ("import sys; sys.path.insert(0, %r);"
            "from bench import measure_prop_throughput;"
            "import json; print('CPU_RESULT '+json.dumps("
            "measure_prop_throughput(batch=1<<15, repeats=5)))" % str(REPO))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=REPO, env=env,
                         check=True)
    for line in out.stdout.splitlines():
        if line.startswith("CPU_RESULT "):
            res = json.loads(line[len("CPU_RESULT "):])
            CPU_CACHE.write_text(json.dumps(res))
            return res["valid_per_sec"]
    raise RuntimeError("CPU baseline child printed no result")


PHASES = {
    "thr": lambda: measure_prop_throughput(backend="pallas"),
    "thr_jnp": lambda: measure_prop_throughput(backend="jnp"),
    "thr_dense": lambda: measure_prop_throughput(backend="pallas",
                                                 dense=True),
    "thr_dense_jnp": lambda: measure_prop_throughput(backend="jnp",
                                                     dense=True),
    "thr_fast": lambda: measure_prop_throughput(backend="pallas",
                                                fast_math=True),
    "rollout_ab": measure_rollout_ab,
    "dev_tts": lambda: measure_device_tts("pallas"),
    "dev_tts_jnp": lambda: measure_device_tts("jnp"),
    "dev_tts_pathless": lambda: measure_device_tts("pallas",
                                                   need_path=False),
    "dev_tts_pathless_jnp": lambda: measure_device_tts("jnp",
                                                       need_path=False),
    "dev_tts_dense": lambda: measure_device_tts("pallas",
                                                scenario="dense24"),
    "dev_tts_dense_jnp": lambda: measure_device_tts("jnp",
                                                    scenario="dense24"),
    "tts": measure_time_to_solution,
    "tts_dense": lambda: measure_time_to_solution(scenario="dense24"),
    "mq128": measure_multi_query,
    "mq1024": lambda: measure_multi_query(rollouts_per_iter=1024),
    "permute_ab": measure_permute_ab,
    "smc": measure_streaming_mc,
    "mc": measure_monte_carlo,
    "cpu": cpu_baseline,
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of: "
                        + ", ".join(PHASES))
    args = parser.parse_args(argv)
    names = [p for p in args.phases.split(",") if p]
    unknown = [p for p in names if p not in PHASES]
    if unknown:
        parser.error(f"unknown phases {unknown}")

    from cudasbmp_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev}", file=sys.stderr)
        return 2
    print(json.dumps({"device": dev, "nvidia_smi": gpu_name_and_power()}),
          flush=True)

    res, errors = {}, {}
    for name in names:
        try:
            res[name] = PHASES[name]()
        except Exception as e:  # noqa: BLE001 — report, run the rest, fail
            errors[name] = repr(e)[:400]
            print(json.dumps({"phase": name, "error": errors[name]}),
                  flush=True)
            continue
        print(json.dumps({"phase": name, "device": dev, "result": res[name]},
                         default=float), flush=True)

    thr = res.get("thr")
    cpu = res.get("cpu")
    print(json.dumps({
        "metric": "valid propagations/sec",
        "value": thr["valid_per_sec"] if thr else None,
        "unit": "valid 10-step rollouts/s",
        "vs_baseline": thr["valid_per_sec"] / (10.0 * cpu)
        if thr and cpu else None,
        "device": dev,
        "failed_phases": sorted(errors),
    }), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
