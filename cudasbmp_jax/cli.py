"""Command-line demo driver — the analog of ``demos/main.cu`` (SURVEY.md L6),
grown into a real CLI.

The reference's only executable hardcodes one scenario and ignores most of its
own ``configurations/`` files (demos/main.cu:19-46; SURVEY.md §2.4.10). This
CLI runs the same hardcoded demo by default (``demo``), honors full
``configurations/`` directories (``plan --configurations DIR``), dumps the
reference-named artifact CSVs, and exposes the throughput probes and
visualization.

Usage:
    python -m cudasbmp_jax.cli demo [--out-dir DIR] [--seed K] [...]
    python -m cudasbmp_jax.cli plan --configurations DIR [...]
    python -m cudasbmp_jax.cli probe [--planner naive|costprop] [--width W]
    python -m cudasbmp_jax.cli viz --artifacts DIR [--out tree.png]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _add_config_args(p: argparse.ArgumentParser) -> None:
    # Flags default to None so "explicitly set on the command line" is
    # detectable: an explicit flag overrides --config even when its value
    # equals the dataclass default (e.g. --seed 0 over a file's seed: 42).
    from cudasbmp_jax.config import KGMTConfig

    d = KGMTConfig()
    p.add_argument("--width", type=float, default=None,
                   help=f"workspace width (default {d.width})")
    p.add_argument("--height", type=float, default=None,
                   help=f"workspace height (default {d.height})")
    p.add_argument("--N", type=int, default=None,
                   help=f"R1 cells per axis (default {d.N})")
    p.add_argument("--n", type=int, default=None,
                   help=f"R2 subcells per axis (default {d.n})")
    p.add_argument("--num-iterations", type=int, default=None,
                   help=f"default {d.num_iterations}")
    p.add_argument("--max-tree-size", type=int, default=None,
                   help=f"default {d.max_tree_size}")
    p.add_argument("--num-disc", type=int, default=None,
                   help=f"default {d.num_disc}")
    p.add_argument("--agent-length", type=float, default=None,
                   help=f"default {d.agent_length}")
    p.add_argument("--goal-threshold", type=float, default=None,
                   help=f"default {d.goal_threshold}")
    p.add_argument("--rollouts-per-iter", type=int, default=None,
                   help=f"default {d.rollouts_per_iter}")
    p.add_argument("--system", default=None,
                   help=f"dynamics system (default {d.system})")
    p.add_argument("--seed", type=int, default=None, help=f"default {d.seed}")
    p.add_argument("--rollout-backend", default=None,
                   choices=["auto", "jnp", "pallas"],
                   help="rollout implementation (see KGMTConfig)")
    p.add_argument("--goal-bias", type=float, default=None,
                   help="fraction of each wave expanded from the top-k "
                   "goal-nearest frontier nodes (0 = reference semantics)")
    # BooleanOptionalAction gives --fast-math/--no-fast-math so a config
    # file's fast_math: true can be overridden back to exact semantics from
    # the command line; default=None keeps the explicit-flag override filter
    # working.
    p.add_argument("--fast-math", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="chained-rotation trig in the fused kernel "
                   "(+6.7%% raw-probe rollouts/s on an H100 at 400 W; "
                   "positions differ from exact only by f32 rounding)")
    p.add_argument("--footprint-width", type=float, default=None,
                   help="agent body width for the narrow-phase oriented-"
                   "footprint collision check (0 = reference broad-phase-"
                   "only semantics)")
    p.add_argument("--adaptive-waves", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="multiple sub-waves per iteration so every frontier "
                   "node gets its full fan-out (reference KGMT.cu:151-158 "
                   "semantics; --no-adaptive-waves caps each iteration at "
                   "one rollouts-per-iter wave)")
    p.add_argument("--exchange-frac", type=float, default=None,
                   help="sharded-tree mode: fraction of each wave expanding "
                   "the cross-shard frontier-exchange pool (0 disables)")
    p.add_argument("--exchange-k", type=int, default=None,
                   help="sharded-tree mode: goal-nearest frontier nodes "
                   "each shard publishes per iteration")
    p.add_argument("--need-path", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="--no-need-path runs the pathless feasibility "
                   "planner: (solved, cost, iterations) only, no tree "
                   "writes — ~2x faster device TTS, bitwise-equal results "
                   "while each iteration's children fit rollouts-per-iter "
                   "(planners/kgmt.py PathlessState)")
    p.add_argument("--config", help="YAML/JSON config file (overridden by flags "
                   "explicitly set on the command line)")


def _config_from_args(args: argparse.Namespace):
    from cudasbmp_jax.config import KGMTConfig

    cfg = KGMTConfig.from_file(args.config) if args.config else KGMTConfig()
    flag_fields = dict(
        width=args.width, height=args.height, N=args.N, n=args.n,
        num_iterations=args.num_iterations, max_tree_size=args.max_tree_size,
        num_disc=args.num_disc, agent_length=args.agent_length,
        goal_threshold=args.goal_threshold,
        rollouts_per_iter=args.rollouts_per_iter, system=args.system,
        seed=args.seed, rollout_backend=args.rollout_backend,
        goal_bias=args.goal_bias, footprint_width=args.footprint_width,
        fast_math=args.fast_math, adaptive_waves=args.adaptive_waves,
        exchange_frac=args.exchange_frac, exchange_k=args.exchange_k,
        need_path=args.need_path,
    )
    overrides = {k: v for k, v in flag_fields.items() if v is not None}
    return dataclasses.replace(cfg, **overrides)


def _run_plan(args: argparse.Namespace, scenario) -> int:
    from cudasbmp_jax.io.csv import write_artifacts
    from cudasbmp_jax.planners.kgmt import KGMT
    from cudasbmp_jax.utils.metrics import iteration_metrics_table, summarize_result

    cfg = _config_from_args(args)
    if not cfg.need_path:
        wants = [f for f in ("shortcut", "refine", "out_dir", "plot")
                 if getattr(args, f, None)]
        if wants:
            print(f"error: --no-need-path keeps no tree/path; "
                  f"incompatible with {', '.join('--' + w.replace('_', '-') for w in wants)}")
            return 2
    planner = KGMT(cfg)
    print(f"Goal: {scenario.goal[0]:f}, {scenario.goal[1]:f}")  # KGMT.cu:100 parity
    result = planner.plan(scenario)
    print(f"time inside KGMT is {result.wall_time_s}")  # KGMT.cu:295 parity
    print(f"Iteration {result.iterations}, Tree size {result.tree_size}")
    if getattr(args, "shortcut", False) and result.solved:
        from cudasbmp_jax.shortcut import shortcut_path

        out = shortcut_path(planner.system, cfg, result.path, scenario.goal,
                            scenario.obstacles)
        print(f"shortcut: cost {out['cost_before']:.3f} -> "
              f"{out['cost_after']:.3f} ({len(result.path) - 1} -> "
              f"{out['n_edges']} edges)")
    if getattr(args, "refine", False) and result.solved:
        from cudasbmp_jax.refine import refine_path

        out = refine_path(planner.system, cfg, result.path, scenario.goal,
                          scenario.obstacles)
        kept = out["valid"] and out["cost_after"] < out["cost_before"]
        print(f"refine: cost {out['cost_before']:.3f} -> "
              f"{out['cost_after']:.3f} "
              f"({'kept' if kept else 'rejected — original retained'}; "
              f"hard-revalidation {'ok' if out['valid'] else 'FAILED'})")
    summary = summarize_result(result)
    print(json.dumps(summary, indent=2))
    if args.verbose:
        print(iteration_metrics_table(result.metrics))
    if args.out_dir:
        written = write_artifacts(result.state, cfg, args.out_dir)
        print(f"wrote {len(written)} artifact CSVs to {args.out_dir}")
        if args.plot:
            from cudasbmp_jax.viz import plot_tree

            out = plot_tree(result=result, config=cfg,
                            obstacles=scenario.obstacles,
                            out_path=f"{args.out_dir}/tree.png",
                            footprint=cfg.footprint)
            print(f"wrote {out}")
    return 0 if result.solved else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="cudasbmp_jax")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_demo = sub.add_parser("demo", help="run the reference demo scenario "
                            "(demos/main.cu workload)")
    _add_config_args(p_demo)
    p_demo.add_argument("--out-dir", help="dump artifact CSVs here")
    p_demo.add_argument("--plot", action="store_true")
    p_demo.add_argument("--verbose", action="store_true")
    p_demo.add_argument("--shortcut", action="store_true",
                        help="post-process the solution with kinodynamic "
                        "shortcutting")
    p_demo.add_argument("--refine", action="store_true",
                        help="post-process the solution with gradient "
                        "trajectory refinement (hard-revalidated)")

    p_plan = sub.add_parser("plan", help="plan a configurations/ scenario")
    _add_config_args(p_plan)
    p_plan.add_argument("--configurations", required=True,
                        help="directory in the reference configurations/ layout")
    p_plan.add_argument("--out-dir", help="dump artifact CSVs here")
    p_plan.add_argument("--plot", action="store_true")
    p_plan.add_argument("--verbose", action="store_true")
    p_plan.add_argument("--shortcut", action="store_true",
                        help="post-process the solution with kinodynamic "
                        "shortcutting")
    p_plan.add_argument("--refine", action="store_true",
                        help="post-process the solution with gradient "
                        "trajectory refinement (hard-revalidated)")

    p_probe = sub.add_parser("probe", help="raw propagation-throughput probes "
                             "(Naive/CostProp planner analogs)")
    p_probe.add_argument("--planner", choices=["naive", "costprop"],
                         default="costprop")
    p_probe.add_argument("--width", type=int, default=1024 * 512,
                         help="rollouts per row (CostProp reference: 524288)")
    p_probe.add_argument("--rows", type=int, default=1)

    p_viz = sub.add_parser("viz", help="plot a dumped artifact directory")
    p_viz.add_argument("--artifacts", required=True)
    p_viz.add_argument("--out", default="tree.png")

    p_rec = sub.add_parser(
        "record", help="step-by-step solve with per-iteration dumps (the "
        "reference's commented-out debug workflow, KGMT.cu:263-291)")
    _add_config_args(p_rec)
    p_rec.add_argument("--out-dir", required=True)
    p_rec.add_argument("--dump-every", type=int, default=1)
    p_rec.add_argument("--checkpoint-every", type=int, default=None)

    p_prof = sub.add_parser("profile", help="capture a jax.profiler trace of "
                            "one solve (view in TensorBoard/Perfetto)")
    _add_config_args(p_prof)
    p_prof.add_argument("--trace-dir", required=True)

    p_multi = sub.add_parser("multi", help="multi-query batch: B init/goal "
                             "pairs solved simultaneously, sharded over all "
                             "devices")
    _add_config_args(p_multi)
    p_multi.add_argument("--batch", type=int, default=64)
    p_multi.add_argument("--goal-jitter", type=float, default=1.0,
                         help="uniform jitter applied to the demo goal per "
                         "problem")
    p_multi.add_argument("--impl", choices=["vmap", "arena"], default="vmap",
                         help="'vmap' = per-problem while_loops (adaptive "
                         "waves supported); 'arena' = the scatter-free "
                         "batched arena (fixed wave width, ~10x faster at "
                         "large B; parallel/batch_kgmt.py)")

    p_sweep = sub.add_parser("sweep", help="Monte-Carlo sweep over random "
                             "obstacle scenarios, data-parallel over devices")
    _add_config_args(p_sweep)
    p_sweep.add_argument("--scenarios", type=int, default=64)
    p_sweep.add_argument("--obstacles", type=int, default=8)
    p_sweep.add_argument("--impl", choices=["vmap", "arena", "stream"],
                         default="vmap",
                         help="'arena' = the scatter-free batched planner "
                         "(fixed wave width; ~10x at large sweeps); "
                         "'stream' = slot-refilling streaming sweep (no "
                         "static-batch barrier, per-scenario results, no "
                         "tree storage)")
    p_sweep.add_argument("--pool", type=int, default=1024,
                         help="resident slot count for --impl stream")

    p_sharded = sub.add_parser(
        "sharded", help="ONE logical tree sharded over the mesh 'tree' axis "
        "(psum'd guidance + cross-shard frontier exchange); optional chunked "
        "checkpointing with exact resume (elastic recovery)")
    _add_config_args(p_sharded)
    p_sharded.add_argument("--n-tree", type=int, default=0,
                           help="tree-axis size (0 = all devices)")
    p_sharded.add_argument("--checkpoint-dir", default=None,
                           help="run in chunks, writing a full-state "
                           "checkpoint after each (plan_checkpointed)")
    p_sharded.add_argument("--checkpoint-every", type=int, default=4,
                           help="iterations per chunk/checkpoint")
    p_sharded.add_argument("--resume-from", default=None,
                           help="checkpoint npz to resume from "
                           "(requires --checkpoint-dir)")

    args = parser.parse_args(argv)

    from cudasbmp_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if args.cmd == "demo":
        from cudasbmp_jax.config import Scenario

        return _run_plan(args, Scenario.demo())

    if args.cmd == "plan":
        from cudasbmp_jax.io.csv import load_scenario

        scenario, grid_params = load_scenario(args.configurations)
        # a PRESENT numR1/numR2 CSV sets the grid unless flags do; an absent
        # one defers to --config / defaults
        if args.N is None and grid_params["N"] is not None:
            args.N = grid_params["N"]
        if args.n is None and grid_params["n"] is not None:
            args.n = grid_params["n"]
        return _run_plan(args, scenario)

    if args.cmd == "probe":
        from cudasbmp_jax.config import Scenario

        if args.planner == "naive":
            from cudasbmp_jax.planners.naive import NaivePlanner as P
        else:
            from cudasbmp_jax.planners.costprop import CostPropPlanner as P
        probe = P(width_rollouts=args.width, rows=args.rows)
        r = probe.plan(Scenario.demo())
        # NaivePlanner.cu:129-130 parity
        print(f"Kernel execution time: {r.kernel_time_s * 1e3:f} milliseconds")
        print(f"Tree size: {r.num_rollouts}")
        print(json.dumps({"rollouts_per_sec": r.rollouts_per_sec}))
        return 0

    if args.cmd == "viz":
        from cudasbmp_jax.viz import plot_tree

        out = plot_tree(artifacts_dir=args.artifacts, out_path=args.out)
        print(f"wrote {out}")
        return 0

    if args.cmd in ("multi", "sweep", "sharded") and \
            getattr(args, "need_path", None) is False:
        # the batch/sharded planners have their own storage designs (the
        # streaming sweep is already tree-free); honoring the flag silently
        # as tree mode would mislead — reject it loudly instead
        print("error: --no-need-path applies to the single-query planner "
              "(demo/plan); the streaming sweep (sweep --impl stream) is "
              "already pathless by design")
        return 2

    if args.cmd == "multi":
        import numpy as np

        from cudasbmp_jax.config import Scenario
        from cudasbmp_jax.parallel import (
            ArenaMultiQueryPlanner,
            MultiQueryPlanner,
            make_planner_mesh,
        )

        cfg = _config_from_args(args)
        base = Scenario.demo()
        B = args.batch
        rng = np.random.default_rng(cfg.seed)
        inits = np.tile(base.init, (B, 1)).astype(np.float32)
        goals = np.tile(base.goal, (B, 1)).astype(np.float32)
        goals[:, :2] += rng.uniform(-args.goal_jitter, args.goal_jitter,
                                    (B, 2)).astype(np.float32)
        obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
        cls = (ArenaMultiQueryPlanner if args.impl == "arena"
               else MultiQueryPlanner)
        planner = cls(cfg, mesh=make_planner_mesh())
        res = planner.plan_batch(inits, goals, obstacles, seed=cfg.seed)
        print(json.dumps({
            "batch": B,
            "solved": int(res.solved.sum()),
            "solve_rate": float(res.solved.mean()),
            "mean_cost": float(res.costs[res.solved].mean())
            if res.solved.any() else None,
            "wall_time_s": res.wall_time_s,
            "solves_per_sec": res.solves_per_sec,
        }, indent=2))
        return 0

    if args.cmd == "sweep":
        cfg = _config_from_args(args)
        if args.impl == "stream":
            from cudasbmp_jax.parallel import StreamingMonteCarloPlanner

            mc = StreamingMonteCarloPlanner(
                cfg, pool=min(args.pool, args.scenarios))
            s = mc.run(num_scenarios=args.scenarios, seed=cfg.seed,
                       num_obstacles=args.obstacles)
            print(json.dumps({
                "scenarios": s.num_scenarios,
                "solve_rate": s.solve_rate,
                "mean_cost_solved": s.mean_cost_solved,
                "cost_quantiles": s.cost_quantiles,
                "num_budget_exhausted": s.num_budget_exhausted,
                "wall_time_s": s.wall_time_s,
                "solves_per_sec": s.solves_per_sec,
            }, indent=2))
            return 0
        from cudasbmp_jax.parallel import MonteCarloPlanner, make_planner_mesh

        mc = MonteCarloPlanner(cfg, mesh=make_planner_mesh(), impl=args.impl)
        s = mc.run(num_scenarios=args.scenarios, seed=cfg.seed,
                   num_obstacles=args.obstacles)
        print(json.dumps({
            "scenarios": s.num_scenarios,
            "solve_rate": s.solve_rate,
            "mean_cost_solved": s.mean_cost_solved,
            "mean_tree_size": s.mean_tree_size,
            "wall_time_s": s.wall_time_s,
            "solves_per_sec": s.solves_per_sec,
            "num_budget_exhausted": s.num_budget_exhausted,
        }, indent=2))
        return 0

    if args.cmd == "sharded":
        import jax

        from cudasbmp_jax.config import Scenario
        from cudasbmp_jax.parallel import ShardedTreePlanner, make_planner_mesh

        if args.resume_from and not args.checkpoint_dir:
            print("error: --resume-from requires --checkpoint-dir",
                  file=sys.stderr)
            return 2
        cfg = _config_from_args(args)
        n_dev = len(jax.devices())
        n_tree = args.n_tree or n_dev
        if n_dev % n_tree != 0:
            print(f"error: --n-tree {n_tree} must divide the device count "
                  f"{n_dev}", file=sys.stderr)
            return 2
        # remaining devices become scenario-axis data parallelism (unused
        # by the single-problem solve but keeps the mesh well-formed)
        planner = ShardedTreePlanner(
            cfg, mesh=make_planner_mesh(n_scenario=n_dev // n_tree,
                                        n_tree=n_tree))
        sc = Scenario.demo()
        if args.checkpoint_dir:
            res = planner.plan_checkpointed(
                sc, args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                resume_from=args.resume_from)
        else:
            res = planner.plan(sc)
        print(json.dumps({
            "n_tree": n_tree,
            "solved": res.solved,
            "cost": res.cost if res.solved else None,
            "iterations": res.iterations,
            "total_tree_size": res.total_tree_size,
            "best_shard": res.best_shard,
            "path_crosses_shards":
                bool(len(set(res.path_shards.tolist())) > 1),
            "wall_time_s": res.wall_time_s,
        }, indent=2))
        return 0 if res.solved else 1

    if args.cmd == "record":
        from cudasbmp_jax.config import Scenario
        from cudasbmp_jax.planners.kgmt import KGMT
        from cudasbmp_jax.utils.metrics import summarize_result

        cfg = _config_from_args(args)
        result = KGMT(cfg).plan_recorded(
            Scenario.demo(), args.out_dir, dump_every=args.dump_every,
            checkpoint_every=args.checkpoint_every,
        )
        print(json.dumps(summarize_result(result), indent=2))
        return 0 if result.solved else 1

    if args.cmd == "profile":
        from cudasbmp_jax.config import Scenario
        from cudasbmp_jax.planners.kgmt import KGMT
        from cudasbmp_jax.utils.profiling import trace_to

        cfg = _config_from_args(args)
        planner = KGMT(cfg)
        planner.plan(Scenario.demo())  # compile outside the trace
        with trace_to(args.trace_dir):
            result = planner.plan(Scenario.demo())
        print(f"trace written to {args.trace_dir}; "
              f"solved={result.solved} wall={result.wall_time_s:.3f}s")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
