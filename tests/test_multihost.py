"""Multi-host simulation without a cluster (SURVEY.md §4.4): two local
processes under jax.distributed, CPU backend, 4 virtual devices each —
exercising the same global-mesh + collective path two real GPU hosts use
(network-coordinated global arrays, cross-process psum)."""

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent(
    """
    import os, sys
    proc_id, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=proc_id,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, %r)
    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.parallel.mesh import make_planner_mesh
    from cudasbmp_jax.parallel.multi_query import MultiQueryPlanner

    assert jax.device_count() == 8 and jax.local_device_count() == 4
    mesh = make_planner_mesh()  # 8-way scenario axis spanning both processes

    cfg = KGMTConfig(num_iterations=100, max_tree_size=16384,
                     rollouts_per_iter=2048)
    planner = MultiQueryPlanner(cfg, mesh=mesh)
    base = Scenario.demo()
    B = 8
    # every process builds the same global batch; jit shards it over the
    # global mesh (the standard multi-host SPMD input pattern)
    inits = np.tile(base.init, (B, 1))
    goals = np.tile(base.goal, (B, 1))
    obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
    shard = NamedSharding(mesh, P("scenario"))
    garr = lambda x: jax.make_array_from_process_local_data(
        shard, np.asarray(x)[
            proc_id * (B // nprocs):(proc_id + 1) * (B // nprocs)],
        (B,) + np.asarray(x).shape[1:],
    )
    # PRNG keys as a global array: ship the raw key data per process and
    # re-wrap under the global sharding
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(0), jnp.arange(B))
    keys_g = jax.jit(jax.random.wrap_key_data, out_shardings=shard)(
        garr(np.asarray(jax.random.key_data(keys))))
    costs, tree_sizes, iters, samples, lengths = planner._solve(
        garr(inits), garr(goals),
        garr(np.broadcast_to(obstacles, (B,) + obstacles.shape)),
        keys_g,
    )
    # fetch the fully-addressable scalar summary on every process
    solved = jax.jit(
        lambda c: jnp.isfinite(c).sum(), out_shardings=NamedSharding(mesh, P())
    )(costs)
    print(f"proc{proc_id}: solved={int(solved)}/8", flush=True)
    assert int(solved) >= 4

    # --- sharded-tree across processes: the region-stats psum rides the
    # cross-process (cross-host analog) link every iteration -----------------------
    from cudasbmp_jax.parallel.sharded_tree import ShardedTreePlanner
    cfg2 = KGMTConfig(num_iterations=60, max_tree_size=2048,
                      rollouts_per_iter=512, adaptive_waves=False)
    tree_mesh = make_planner_mesh(n_scenario=1, n_tree=8)
    st = ShardedTreePlanner(cfg2, mesh=tree_mesh)
    r = st.plan(Scenario.demo())
    assert r.solved, "sharded tree must solve across 2 processes"
    sc = r.r1_scores_by_shard
    assert sc.shape == (8, 256)
    for i in range(1, 8):
        assert (sc[0] == sc[i]).all(), "shards disagree on global scores"
    print(f"proc{proc_id}: sharded-tree cost={r.cost:.3f}", flush=True)

    # --- streaming Monte-Carlo across processes: one independent pool per
    # device of the 2-process global mesh, disjoint id ranges; the union
    # must reproduce a LOCAL single-pool sweep bit-for-bit (per-scenario
    # RNG keying) ----------------------------------------------------------
    from cudasbmp_jax.parallel.streaming_mc import StreamingMonteCarloPlanner
    scfg = KGMTConfig(rollouts_per_iter=128, num_iterations=30,
                      rollout_backend="jnp", adaptive_waves=False,
                      max_tree_size=2)
    flat = make_planner_mesh()  # 8-way scenario axis over both processes
    smc = StreamingMonteCarloPlanner(scfg, pool=2)
    s = smc.run_sharded(num_scenarios=16, mesh=flat, seed=5, num_obstacles=5)
    local = StreamingMonteCarloPlanner(scfg, pool=4).run(
        num_scenarios=16, seed=5, num_obstacles=5)
    np.testing.assert_array_equal(s.costs, local.costs)
    np.testing.assert_array_equal(s.iters, local.iters)
    print(f"proc{proc_id}: streaming rate={s.solve_rate:.2f}", flush=True)
    print(f"proc{proc_id}: MULTIHOST_OK", flush=True)
    """
) % str(REPO)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_multi_query(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out


RECOVERY_WORKER = textwrap.dedent(
    """
    import os, sys, hashlib
    mode, proc_id, nprocs, port, ckpt_dir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=proc_id,
    )
    import numpy as np
    sys.path.insert(0, %r)
    from pathlib import Path
    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.io.checkpoint import load_checkpoint
    from cudasbmp_jax.parallel.mesh import make_planner_mesh
    from cudasbmp_jax.parallel.sharded_tree import ShardedTreePlanner

    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    st = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_scenario=1,
                                                        n_tree=8))
    sc = Scenario.demo()
    if mode == "victim":
        # slow chunks so the parent's SIGKILL lands mid-solve
        r = st.plan_checkpointed(sc, ckpt_dir, checkpoint_every=2,
                                 chunk_delay_s=0.5)
        print("FINISHED_UNKILLED", flush=True)  # parent treats this as failure
    else:  # resume: newest checkpoint that loads intact
        ckpts = sorted(Path(ckpt_dir).glob("sharded_checkpoint_*.npz"),
                       key=lambda p: int(p.stem.split("_")[-1]), reverse=True)
        state = None
        for p in ckpts:
            try:
                state = load_checkpoint(p)
                break
            except Exception:
                continue
        assert state is not None, "no checkpoint survived the kill"
        r = st.plan_checkpointed(sc, Path(ckpt_dir) / "resumed",
                                 checkpoint_every=2, resume_from=p)
        assert r.solved
        h = hashlib.md5(np.ascontiguousarray(r.path).tobytes()).hexdigest()
        print(f"proc{proc_id}: RESULT cost={r.cost:.6f} iters={r.iterations} "
              f"path={h}", flush=True)
    """
) % str(REPO)


@pytest.mark.slow
def test_two_process_kill_and_restart(tmp_path):
    """Multi-host elastic recovery (SURVEY.md §5): a
    2-process sharded-tree solve is SIGKILLed mid-flight; a fresh 2-process
    job restores the newest intact checkpoint and finishes with the exact
    result an uninterrupted run produces (reference computed in-process on
    the same 8-device mesh — the SPMD program is identical either way)."""
    import hashlib
    import os
    import signal
    import time as _time

    import numpy as np

    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.parallel.mesh import make_planner_mesh
    from cudasbmp_jax.parallel.sharded_tree import ShardedTreePlanner

    cfg = KGMTConfig(num_iterations=60, max_tree_size=2048,
                     rollouts_per_iter=512, adaptive_waves=False)
    ref = ShardedTreePlanner(
        cfg, mesh=make_planner_mesh(n_scenario=1, n_tree=8)).plan(
        Scenario.demo())
    assert ref.solved
    ref_hash = hashlib.md5(np.ascontiguousarray(ref.path).tobytes()).hexdigest()

    script = tmp_path / "worker.py"
    script.write_text(RECOVERY_WORKER)
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()

    # --- phase 1: launch, then SIGKILL one process mid-solve ---------------
    port = _free_port()
    victims = [
        subprocess.Popen(
            [sys.executable, str(script), "victim", str(i), "2", str(port),
             str(ckpt_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    deadline = _time.time() + 300
    while _time.time() < deadline:
        if list(ckpt_dir.glob("sharded_checkpoint_*.npz")):
            break
        if any(p.poll() is not None for p in victims):
            outs = [p.communicate()[0] for p in victims]
            raise AssertionError(f"victim died before kill: {outs}")
        _time.sleep(0.05)
    os.kill(victims[1].pid, signal.SIGKILL)  # exact PID we started
    victims[1].wait()
    assert victims[1].returncode == -signal.SIGKILL
    # proc 0 now hangs in (or errors out of) a cross-process collective;
    # terminate it too — in production the job scheduler does exactly this
    victims[0].send_signal(signal.SIGKILL)
    victims[0].wait()
    out0 = victims[0].stdout.read() if victims[0].stdout else ""
    assert "FINISHED_UNKILLED" not in out0, "kill landed after completion"

    # --- phase 2: fresh 2-process job resumes from the newest checkpoint ---
    port = _free_port()
    resumers = [
        subprocess.Popen(
            [sys.executable, str(script), "resume", str(i), "2", str(port),
             str(ckpt_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for i, p in enumerate(resumers):
        out, _ = p.communicate(timeout=420)
        assert p.returncode == 0, f"resume proc{i} failed:\n{out[-3000:]}"
        assert f"cost={ref.cost:.6f}" in out, out[-1000:]
        assert f"path={ref_hash}" in out, out[-1000:]


FOURPROC_WORKER = textwrap.dedent(
    """
    import os, sys
    proc_id, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=proc_id,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, %r)
    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.parallel.mesh import make_planner_mesh
    from cudasbmp_jax.parallel.sharded_multi_query import (
        ShardedMultiQueryPlanner,
    )

    assert jax.device_count() == 8 and jax.local_device_count() == 2
    # (scenario=4, tree=2): the tree pairs are the two LOCAL devices of each
    # process (intra-host analog); the scenario axis spans all four
    # processes, so its gathers cross 3 cross-host-analog hops — the >1-hop
    # pattern the 2-process test cannot exercise
    mesh = make_planner_mesh(n_scenario=4, n_tree=2)

    cfg = KGMTConfig(num_iterations=60, max_tree_size=8192,
                     rollouts_per_iter=512, adaptive_waves=False)
    planner = ShardedMultiQueryPlanner(cfg, mesh=mesh)
    base = Scenario.demo()
    B = 4  # one problem per scenario slot, sharded over each device pair
    inits = np.tile(base.init, (B, 1))
    goals = np.tile(base.goal, (B, 1))
    obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
    obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
    shard = NamedSharding(mesh, P("scenario"))
    nloc = B // 4
    garr = lambda x: jax.make_array_from_process_local_data(
        shard, np.ascontiguousarray(
            np.asarray(x)[proc_id * nloc:(proc_id + 1) * nloc]),
        (B,) + np.asarray(x).shape[1:],
    )
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(0), jnp.arange(B))
    keys_g = jax.jit(jax.random.wrap_key_data, out_shardings=shard)(
        garr(np.asarray(jax.random.key_data(keys))))
    outs = planner._solve(garr(inits), garr(goals), garr(obstacles), keys_g)
    rep = NamedSharding(mesh, P())
    costs = np.asarray(jax.jit(lambda c: c, out_shardings=rep)(outs[0]))
    # [B, n_tree] per-shard costs; per-problem best over the tree axis
    best = np.nanmin(np.where(np.isfinite(costs), costs, np.nan), axis=1)
    solved = np.isfinite(best)
    assert solved.sum() >= 3, costs
    for b in range(B):
        print(f"proc{proc_id}: COST[{b}]="
              f"{best[b]:.6f}" if solved[b] else
              f"proc{proc_id}: COST[{b}]=unsolved", flush=True)
    print(f"proc{proc_id}: FOURPROC_OK", flush=True)
    """
) % str(REPO)


@pytest.mark.slow
def test_four_process_sharded_multi_query():
    """4 processes x 2 virtual devices: sharded multi-query on the combined
    (scenario=4, tree=2) mesh across processes — tree collectives stay
    process-local, the scenario axis spans >1 cross-host-analog hop. The
    SPMD program is process-count-invariant, so the costs must
    equal an in-process 8-device run of the same program bit-for-bit."""
    import re
    import tempfile

    import numpy as np

    from cudasbmp_jax.config import KGMTConfig, Scenario
    from cudasbmp_jax.parallel.mesh import make_planner_mesh
    from cudasbmp_jax.parallel.sharded_multi_query import (
        ShardedMultiQueryPlanner,
    )

    cfg = KGMTConfig(num_iterations=60, max_tree_size=8192,
                     rollouts_per_iter=512, adaptive_waves=False)
    base = Scenario.demo()
    B = 4
    ref = ShardedMultiQueryPlanner(
        cfg, mesh=make_planner_mesh(n_scenario=4, n_tree=2)).plan_batch(
        np.tile(base.init, (B, 1)), np.tile(base.goal, (B, 1)),
        base.padded_obstacles(cfg.max_obstacles)[0], seed=0)
    assert ref.solved.sum() >= 3

    with tempfile.TemporaryDirectory() as td:
        script = Path(td) / "worker.py"
        script.write_text(FOURPROC_WORKER)
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, str(script), str(i), "4", str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in range(4)
        ]
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-3000:]}"
        assert "FOURPROC_OK" in out
        got = dict(re.findall(r"COST\[(\d+)\]=([\d.]+|unsolved)", out))
        for b in range(B):
            if ref.solved[b]:
                assert got[str(b)] == f"{ref.costs[b]:.6f}", (b, got, ref.costs)
