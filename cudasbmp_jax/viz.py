"""Tree / workspace visualization — Python replacement for the reference's
MATLAB scripts (visualization/visualizationKGMT_Single.m etc., SURVEY.md §3.4).

Like the MATLAB `_Single` script, edges are drawn by RE-INTEGRATING each
node's stored control from its parent state (visualizationKGMT_Single.m:86-112)
rather than straight lines — so a propagator bug is visible as curves that
miss their child nodes. Reads either a live KGMTResult or a directory of the
reference-named artifact CSVs.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np

from cudasbmp_jax.config import KGMTConfig, SAMPLE_DIM
from cudasbmp_jax.systems.registry import get_system


@functools.lru_cache(maxsize=16)
def _edge_integrator(system, num_disc: int):
    """Jitted vmap-over-edges re-integration: [E, S], [E, C+1] ->
    [E, num_disc+1, state_dim]. One device dispatch for the WHOLE tree
    instead of ~num_disc device calls per edge in a Python loop — full
    30k-node trees render without an edge cap."""
    import jax
    import jax.numpy as jnp

    def one(x0, c):
        a_steer, dur = c[:-1], c[-1]
        dt = dur / num_disc

        def step(s, _):
            s2 = system.step(s, a_steer, dt)
            return s2, s2

        _, sts = jax.lax.scan(step, x0, None, length=num_disc)
        return jnp.concatenate([x0[None], sts], axis=0)

    return jax.jit(jax.vmap(one))


def _integrate_edges(system, x0s: np.ndarray, controls: np.ndarray,
                     num_disc: int) -> np.ndarray:
    """Batch re-integration of many edges; returns [E, num_disc+1, state_dim]
    full state trajectories (same math as the MATLAB cross-check,
    visualizationKGMT_Single.m:86-112, vmapped over edges)."""
    import jax.numpy as jnp

    if len(x0s) == 0:
        return np.zeros((0, num_disc + 1, system.state_dim), np.float32)
    fn = _edge_integrator(system, num_disc)
    return np.asarray(fn(jnp.asarray(x0s[:, : system.state_dim]),
                         jnp.asarray(controls)))


def _integrate_edge(system, x0: np.ndarray, control: np.ndarray, num_disc: int
                    ) -> np.ndarray:
    """Re-integrate one edge on the host; returns [num_disc+1, 2] positions."""
    return _integrate_edge_states(system, x0, control, num_disc)[:, :2]


def _integrate_edge_states(system, x0: np.ndarray, control: np.ndarray,
                           num_disc: int) -> np.ndarray:
    """Re-integrate one edge; returns [num_disc+1, state_dim] full states."""
    import jax.numpy as jnp

    state = jnp.asarray(x0[: system.state_dim])
    a_steer = jnp.asarray(control[:-1])
    dt = float(control[-1]) / num_disc
    states = [np.asarray(state)]
    for _ in range(num_disc):
        state = system.step(state, a_steer, dt)
        states.append(np.asarray(state))
    return np.stack(states)


def plot_tree(result=None, artifacts_dir: str | os.PathLike | None = None,
              config: KGMTConfig | None = None, out_path: str = "tree.png",
              obstacles: np.ndarray | None = None,
              max_edges: int | None = None,
              show_grid: bool = True,
              footprint: tuple[float, float] | None = None,
              _samples_path: os.PathLike | None = None,
              _parents_path: os.PathLike | None = None) -> str:
    """Render the search tree over the workspace; returns the written path.

    With ``footprint=(half_len, half_wid)`` (e.g. ``config.footprint``), the
    agent's oriented body rectangle is drawn at every pose along the solution
    path — the visual check for the narrow-phase collision mode."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = config or KGMTConfig()
    system = get_system(cfg.system)

    if result is not None:
        samples = np.asarray(result.state.tree_samples)
        parents = np.asarray(result.state.tree_parent)
        tree_size = result.tree_size
        path_nodes = result.path_nodes
    else:
        if _samples_path is not None:
            sp, pp = Path(_samples_path), Path(_parents_path)
        else:
            d = Path(artifacts_dir)
            sp, pp = d / "samples.csv", d / "parentRelations.csv"
        samples = np.loadtxt(sp, delimiter=",").reshape(-1, SAMPLE_DIM)
        parents = np.loadtxt(pp, delimiter=",").astype(int)
        tree_size = int((parents >= 0).sum()) + 1
        path_nodes = None

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(0, cfg.width)
    ax.set_ylim(0, cfg.height)
    ax.set_aspect("equal")

    if show_grid:
        for i in range(cfg.N + 1):
            ax.axvline(i * cfg.r1_size, color="0.9", lw=0.5, zorder=0)
            ax.axhline(i * cfg.r1_size, color="0.9", lw=0.5, zorder=0)

    if obstacles is not None:
        for (x0, y0, x1, y1) in obstacles:
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       color="0.3", zorder=2))

    # edges: re-integrated trajectories (the MATLAB cross-check), all edges
    # in ONE vmapped device call + one LineCollection (max_edges=None draws
    # the full tree; the former per-edge host loop needed a 2000-edge cap)
    children = np.arange(1, tree_size)
    # sharded trees store GLOBAL (shard*M + slot) parent ids; a single
    # shard's dump can only resolve local parents, so foreign-parent edges
    # are dropped (aliasing them into the local id range would draw edges
    # from unrelated nodes)
    ok = (parents[1:tree_size] >= 0) & (parents[1:tree_size] < len(samples))
    children = children[ok]
    if max_edges is not None and len(children) > max_edges:
        children = children[:max_edges]
    if len(children) > 0:
        from matplotlib.collections import LineCollection

        par = parents[children]
        sts = _integrate_edges(system, samples[par],
                               samples[children, 4:7], cfg.num_disc)
        ax.add_collection(LineCollection(
            sts[:, :, :2], colors="tab:blue", linewidths=0.3, alpha=0.4,
            zorder=1))

    ax.scatter(samples[:tree_size, 0], samples[:tree_size, 1], s=1,
               color="tab:blue", zorder=3)

    if path_nodes is not None and len(path_nodes) > 1:
        for i in range(1, len(path_nodes)):
            p, c = path_nodes[i - 1], path_nodes[i]
            sts = _integrate_edge_states(system, samples[p], samples[c, 4:7],
                                         cfg.num_disc)
            ax.plot(sts[:, 0], sts[:, 1], color="tab:red", lw=2.0, zorder=4)
            if footprint is not None:
                from cudasbmp_jax.geometry.footprint import footprint_corners

                import jax.numpy as jnp

                hi = getattr(system, "heading_index", None)
                theta = sts[:, hi] if hi is not None else np.zeros(len(sts))
                corners = np.asarray(footprint_corners(
                    jnp.asarray(sts[:, 0]), jnp.asarray(sts[:, 1]),
                    jnp.asarray(theta), footprint[0], footprint[1]))
                for quad in corners:
                    ax.add_patch(plt.Polygon(quad, closed=True, fill=False,
                                             edgecolor="tab:orange", lw=0.5,
                                             zorder=4))

    ax.set_title(f"KGMT tree ({tree_size} nodes)")
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_steps(record_dir: str | os.PathLike, config: KGMTConfig | None = None,
               obstacles: np.ndarray | None = None,
               out_dir: str | os.PathLike = "frames",
               every: int = 1, max_edges: int | None = None) -> list[str]:
    """Per-iteration tree-growth frames from a plan_recorded dump — the
    visualizationKGMT_Steps.m workflow (reads Data/Samples/samples<i>.csv
    style per-iteration files). Returns the written frame paths."""
    rec = Path(record_dir)
    outd = Path(out_dir)
    outd.mkdir(parents=True, exist_ok=True)
    frames = []
    sample_files = sorted(
        (rec / "Samples").glob("samples*.csv"),
        key=lambda p: int(p.stem[len("samples"):]),
    )
    for f in sample_files[::every]:
        it = int(f.stem[len("samples"):])
        frame = plot_tree(
            artifacts_dir=None, config=config, obstacles=obstacles,
            out_path=str(outd / f"tree_{it:04d}.png"), max_edges=max_edges,
            _samples_path=f,
            _parents_path=rec / "Parents" / f"parents{it}.csv",
        )
        frames.append(frame)
    return frames


def plot_metrics(metrics: dict, out_path: str = "metrics.png") -> str:
    """Per-iteration counters: frontier size, valid/accepted, tree growth."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    it = np.arange(len(metrics["frontier_size"]))
    axes[0].plot(it, metrics["frontier_size"])
    axes[0].set_title("frontier size")
    axes[1].plot(it, metrics["valid"], label="valid")
    axes[1].plot(it, metrics["accepted"], label="accepted")
    axes[1].legend()
    axes[1].set_title("rollouts per iteration")
    axes[2].plot(it, metrics["tree_size"])
    axes[2].set_title("tree size")
    for ax in axes:
        ax.set_xlabel("iteration")
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_sharded_path(result, config: KGMTConfig | None = None,
                      obstacles: np.ndarray | None = None,
                      out_path: str = "sharded_path.png") -> str:
    """Render a ShardedTreeResult / one ShardedMultiQueryResult problem's
    stitched solution path, each edge colored by the shard that OWNS its
    child node — the visual witness that the sharded mode is one logical
    tree whose paths cross shard boundaries. Edges are re-integrated from
    the stored controls (the MATLAB _Single cross-check), so a drawn edge
    that misses its node would expose a stitching bug."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = config or KGMTConfig()
    system = get_system(cfg.system)
    path = np.asarray(result.path if hasattr(result, "path") else result)
    shards = np.asarray(result.path_shards)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(0, cfg.width)
    ax.set_ylim(0, cfg.height)
    ax.set_aspect("equal")
    if obstacles is not None:
        for (x0, y0, x1, y1) in obstacles:
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       color="0.3", zorder=2))
    cmap = plt.get_cmap("tab10")
    seen = set()
    for i in range(1, len(path)):
        sts = _integrate_edge_states(system, path[i - 1], path[i, 4:7],
                                     cfg.num_disc)
        d = int(shards[i])
        label = f"shard {d}" if d not in seen else None
        seen.add(d)
        ax.plot(sts[:, 0], sts[:, 1], color=cmap(d % 10), lw=2.0, zorder=4,
                label=label)
    ax.scatter(path[:, 0], path[:, 1], s=14,
               c=[cmap(int(d) % 10) for d in shards], zorder=5)
    n_cross = int((shards[1:] != shards[:-1]).sum())
    ax.set_title(f"sharded-tree path: {len(path)} nodes, "
                 f"{len(seen)} shards, {n_cross} boundary crossings")
    if seen:
        ax.legend(loc="upper right", fontsize=8)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path
