"""Planner and scenario configuration.

Realizes the intent of the reference's (empty) ``systems/car.yaml`` and the
hardcoded constants in ``demos/main.cu:19-28`` / ``src/planners/KGMT.cu:5-8``:
one declarative config object covering workspace, grid resolution, capacity,
iteration budget, integration resolution, control bounds, goal threshold and
seed — loadable from flat ``key: value`` YAML files (``systems/*.yaml``),
from JSON, and from the reference's ``configurations/`` CSV scenario layout
(see cudasbmp_jax.io.csv).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

SAMPLE_DIM = 7  # x, y, theta, v, accel, steering, duration   (KGMT.cu:5)
STATE_DIM = 4  # x, y, theta, v                               (KGMT.cu:6)
WORKSPACE_DIM = 2  # planar workspace                          (statePropagator.cu:3)


@dataclasses.dataclass(frozen=True)
class KGMTConfig:
    """Static (compile-time) configuration of the KGMT planner.

    Defaults reproduce the reference demo scenario (demos/main.cu:19-28).
    """

    # Workspace (demos/main.cu:19-20)
    width: float = 20.0
    height: float = 20.0
    # Two-level region grid: N x N coarse R1 cells, each split n x n into R2
    # subcells (KGMT.cu:13-14; demos/main.cu:21-22).
    N: int = 16
    n: int = 8
    # Iteration budget and tree capacity (demos/main.cu:23-24).
    num_iterations: int = 100
    max_tree_size: int = 30000
    # Rollout integration steps per edge (demos/main.cu:25).
    num_disc: int = 10
    # Agent wheelbase for the kinematic bicycle (demos/main.cu:26).
    agent_length: float = 1.0
    # Goal-region radius in (x, y) (demos/main.cu:27).
    goal_threshold: float = 0.5
    # Fan-out: rollouts per frontier node in the normal regime (KGMT.cu:152).
    fanout: int = 32
    # Fixed rollout batch per iteration (static shapes). The reference's
    # two launch regimes (32/node vs fill-remaining-capacity,
    # KGMT.cu:151-219) collapse into one dense batch of this size with
    # round-robin parent assignment; slots beyond
    # min(fanout*frontier, capacity_left) are masked out.
    rollouts_per_iter: int = 4096
    # Adaptive wave sizing (default True): when fanout*frontier_size exceeds
    # rollouts_per_iter, the iteration runs ceil(target/R) sub-waves so every
    # frontier node still gets its full fan-out — matching the reference's
    # launch whose width GROWS with the frontier (KGMT.cu:151-158: wave =
    # 32*activeSize rollouts). False caps each iteration at one R-slot wave
    # (round-robin thins the per-node fan-out on wide frontiers).
    adaptive_waves: bool = True
    # Score-formula epsilon (KGMT.cu:131 passes 0.01).
    epsilon: float = 0.01
    # Dynamical system name from cudasbmp_jax.systems.registry.
    system: str = "bicycle"
    # PRNG seed (the reference uses time(NULL), KGMT.cu:111 — we are
    # deterministic by construction).
    seed: int = 0
    # If the expansion wave accepts zero children the reference's frontier
    # empties permanently and the planner spins (SURVEY.md §2.4 discussion).
    # True (default) retries the same frontier instead.
    keep_frontier_on_stall: bool = True
    # Static capacity of the obstacle set (scenarios pad up to this).
    max_obstacles: int = 32
    # Anytime mode (beyond-reference): the reference breaks at the FIRST
    # solution (feasibility search, KGMT.cu:251-254). False keeps iterating
    # through the full budget, retaining the cheapest goal hit seen (the
    # goal check already tracks the min-cost hit per wave).
    stop_on_first_solution: bool = True
    # Goal-biased expansion (beyond-reference extension; 0.0 = off, exact
    # reference semantics): this fraction of each wave's rollout slots draws
    # parents from the goal_bias_k frontier nodes NEAREST the goal, selected
    # on device with a top-k reduction over the tree (the north-star's
    # "nearest-neighbor selection as segmented top-k"). The rest of the wave
    # keeps the uniform round-robin assignment.
    goal_bias: float = 0.0
    goal_bias_k: int = 32
    # Narrow-phase collision (beyond-reference; 0.0 = off, exact reference
    # broad-phase-only semantics): when > 0, every post-step pose also tests
    # the agent's oriented rectangular body — agent_length long (the
    # reference Agent's wheelbase doubles as its body length, Agent.h:6-26),
    # this wide, extending forward from the pose point — against every
    # obstacle (geometry/footprint.py). Realizes the footprint the
    # reference's host Agent carries but never consults.
    # GUARANTEE: the body test runs at the num_disc DISCRETE post-step poses;
    # only the pose point's swept AABB guards the segment between poses, so
    # at large v*dt a body corner can tunnel past a very thin obstacle
    # between consecutive poses. Raise num_disc (or keep obstacles thicker
    # than max_speed*dt) when that matters.
    footprint_width: float = 0.0
    # Sharded-tree frontier exchange (P7, SURVEY.md §7 hard-part 5; only
    # active when kgmt_iteration runs under a mesh axis): every iteration
    # each shard all_gathers the exchange_k goal-nearest nodes of every
    # shard's frontier and reserves exchange_frac of each wave's rollout
    # slots for parents drawn from that pool. Children of foreign parents
    # are committed locally with GLOBAL (shard*max_tree_size + slot) parent
    # references, making the D shard-local trees ONE logical tree whose
    # paths can cross shards — the collective analog of the reference's
    # single compacted frontier (KGMT.cu:139-147). 0.0 disables exchange
    # (guidance-coupled independent trees, the round-1 behavior).
    exchange_frac: float = 0.25
    exchange_k: int = 64
    # Fast-math rollouts (beyond-reference; False = exact reference float
    # semantics): systems with the fast hooks (bicycle, unicycle, dubins)
    # replace per-step cos/sin in the fused Pallas kernel with chained 2-D
    # rotations. Positions drift from the exact path only by f32 rounding
    # (typically ~1e-5; up to ~1e-2 absolute for near-singular steering
    # where tan(s) is huge); still fully deterministic per seed. The kernel
    # only: rejected with rollout_backend='jnp', and an error wherever the
    # 'auto' backend resolves to the jnp path.
    # MIXED-SEMANTICS CAVEAT: refine/shortcut re-validate edges with the
    # EXACT jnp rollout, so ~1% boundary-grazing edges a fast_math solve
    # accepted can fail exact re-validation there (reported via their
    # 'valid'/acceptance outputs, never silently) — and vice versa.
    fast_math: bool = False
    # Pathless feasibility mode (beyond-reference; True = full reference
    # semantics): False answers only (solved?, cost, iterations) — the
    # frontier is carried in an R-row register buffer and the [M, 7] tree is
    # never written, removing the commit scatters of every wave. Results
    # are bitwise identical to the tree mode while every iteration's
    # accepted children fit R rows (planners/kgmt.py PathlessState docs),
    # including under
    # goal_bias (the biased top-k restricts to the frontier in both modes);
    # no path extraction, no plan_recorded.
    need_path: bool = True
    # Rollout implementation: 'auto' uses the fused Pallas kernel on a GPU
    # for systems with the SoA hooks and the XLA-compiled jnp path
    # elsewhere; 'pallas'/'jnp' force one ('pallas' off a GPU raises —
    # planners/kgmt.py _dispatch_rollout).
    rollout_backend: str = "auto"

    def __post_init__(self) -> None:
        problems = []
        for name, lo in (("N", 1), ("n", 1), ("num_disc", 1),
                         ("rollouts_per_iter", 1), ("fanout", 1),
                         ("max_tree_size", 1), ("max_obstacles", 1),
                         ("num_iterations", 0)):
            if getattr(self, name) < lo:
                problems.append(f"{name} must be >= {lo}")
        for name in ("width", "height", "goal_threshold", "agent_length"):
            if getattr(self, name) <= 0:
                problems.append(f"{name} must be > 0")
        if self.rollout_backend not in ("auto", "jnp", "pallas"):
            problems.append(f"unknown rollout_backend {self.rollout_backend!r}")
        if self.fast_math and self.rollout_backend == "jnp":
            problems.append("fast_math exists only in the fused kernel, not "
                            "with rollout_backend='jnp'")
        if not 0.0 <= self.goal_bias <= 1.0:
            problems.append("goal_bias must be in [0, 1]")
        if not 0.0 <= self.exchange_frac <= 1.0:
            problems.append("exchange_frac must be in [0, 1]")
        if self.exchange_k < 1:
            problems.append("exchange_k must be >= 1")
        if self.goal_bias_k < 1:
            problems.append("goal_bias_k must be >= 1")
        if self.footprint_width < 0:
            problems.append("footprint_width must be >= 0")
        if problems:
            raise ValueError("invalid KGMTConfig: " + "; ".join(problems))

    @property
    def footprint(self) -> tuple[float, float] | None:
        """Narrow-phase body half-dims (half_len, half_wid) for
        geometry/footprint.py, or None when footprint_width == 0 (the
        reference's broad-phase-only semantics). Length is the agent
        wheelbase — the rectangle models.Agent carries (Agent.h:6-26)."""
        if self.footprint_width <= 0.0:
            return None
        return (self.agent_length / 2.0, self.footprint_width / 2.0)

    @property
    def r1_size(self) -> float:
        """Coarse cell edge length (KGMT.cu:13)."""
        return self.width / self.N

    @property
    def r2_size(self) -> float:
        """Sub-cell edge length (KGMT.cu:14)."""
        return self.width / (self.n * self.N)

    @property
    def num_r1(self) -> int:
        return self.N * self.N

    @property
    def num_r2(self) -> int:
        return self.N * self.N * self.n * self.n

    @staticmethod
    def derived_tree_capacity(N: int, n: int) -> int:
        """Tree capacity scaled to the guidance grid, for workloads that
        refine N/n beyond the reference demo: acceptance is
        ``rand <= score OR virgin-R2-subcell`` (KGMT.cu:394-400), so the
        early-phase accepted volume scales with the number of R2 subcells —
        quadrupling the grid at the reference's fixed 30k capacity fills the
        tree ~13 iterations before the demo goal is reachable. Rule: 2x the
        subcell count,
        floored at the reference's 30k (demos/main.cu:24)."""
        return max(30000, 2 * N * N * n * n)

    def replace(self, **kw: Any) -> "KGMTConfig":
        return dataclasses.replace(self, **kw)

    # ---- serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KGMTConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_file(cls, path: str) -> "KGMTConfig":
        """Load from a flat ``key: value`` YAML file (``.yaml``/``.yml``,
        the layout of ``systems/*.yaml``) or from JSON."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            data = parse_flat_yaml(text)
        else:
            data = json.loads(text)
        return cls.from_dict(data)

    def to_file(self, path: str) -> None:
        """Write JSON, or flat YAML for a ``.yaml``/``.yml`` path."""
        if path.endswith((".yaml", ".yml")):
            text = "".join(f"{k}: {json.dumps(v)}\n"
                           for k, v in self.to_dict().items())
        else:
            text = json.dumps(self.to_dict(), indent=2)
        with open(path, "w") as f:
            f.write(text)


def _yaml_scalar(text: str) -> Any:
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_flat_yaml(text: str) -> dict:
    """Read the YAML subset the config files use: one ``key: scalar`` per
    line, ``#`` comments, blank lines. Scalars are booleans, null, ints,
    floats and plain or quoted strings. Anything else (nesting, lists,
    multi-line values) raises ValueError rather than being misread."""
    data = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#") or line == "---":
            continue
        if raw[0].isspace() or ":" not in line:
            raise ValueError(f"line {lineno}: not a flat 'key: value' "
                             f"entry: {raw!r}")
        key, _, value = line.partition(":")
        value = value.strip()
        if value[:1] in ("'", '"'):
            end = value.find(value[0], 1)
            rest = value[end + 1:].strip() if end > 0 else "?"
            if rest and not rest.startswith("#"):
                raise ValueError(f"line {lineno}: bad quoted value: {raw!r}")
            data[key.strip()] = value[1:end]
            continue
        value = value.split(" #", 1)[0].strip()
        if value[:1] in ("[", "{", "|", ">", "&", "*", "-") and value != "-":
            raise ValueError(f"line {lineno}: only scalar values are "
                             f"supported: {raw!r}")
        data[key.strip()] = _yaml_scalar(value)
    return data


@dataclasses.dataclass
class Scenario:
    """A planning problem: start/goal samples + axis-aligned box obstacles.

    Mirrors the reference's ``configurations/`` CSV layout (init/goal 7-float
    samples, obstacles as ``xmin,ymin,xmax,ymax`` rows — helper.cu:11-34) and
    the demo's hardcoded scenario (demos/main.cu:33-61).
    """

    init: np.ndarray  # [SAMPLE_DIM]
    goal: np.ndarray  # [SAMPLE_DIM]
    obstacles: np.ndarray  # [num_obstacles, 4] xmin,ymin,xmax,ymax

    def __post_init__(self) -> None:
        self.init = np.asarray(self.init, dtype=np.float32).reshape(-1)[:SAMPLE_DIM]
        self.goal = np.asarray(self.goal, dtype=np.float32).reshape(-1)[:SAMPLE_DIM]
        self.init = np.pad(self.init, (0, SAMPLE_DIM - self.init.shape[0]))
        self.goal = np.pad(self.goal, (0, SAMPLE_DIM - self.goal.shape[0]))
        self.obstacles = np.asarray(self.obstacles, dtype=np.float32).reshape(-1, 4)

    @classmethod
    def demo(cls) -> "Scenario":
        """The reference demo's hardcoded workload (demos/main.cu:33-46):
        start (5,5), goal (2,18) in a 20x20 workspace with obstacles.csv."""
        init = np.zeros(SAMPLE_DIM, np.float32)
        init[0], init[1] = 5.0, 5.0
        goal = np.zeros(SAMPLE_DIM, np.float32)
        goal[0], goal[1] = 2.0, 18.0
        return cls(init=init, goal=goal, obstacles=default_obstacles())

    @classmethod
    def dense(cls, num_obstacles: int = 24, seed: int = 0) -> "Scenario":
        """Dense-obstacle stress workload (BASELINE.json config 3): a jittered
        grid of AABBs filling the workspace with a guaranteed-free border and
        corridors, start (1,1) -> goal (19,19). Stresses the fused
        collision/occupancy path (the per-step obstacle loop)."""
        rng = np.random.default_rng(seed)
        side = int(np.ceil(np.sqrt(num_obstacles)))
        boxes = []
        # lay obstacles on a side x side grid over [2, 18]^2, jittered, sized
        # to leave ~1-unit corridors between neighbors
        pitch = 16.0 / side
        for i in range(side):
            for j in range(side):
                if len(boxes) >= num_obstacles:
                    break
                cx = 2.0 + (i + 0.5) * pitch + rng.uniform(-0.15, 0.15) * pitch
                cy = 2.0 + (j + 0.5) * pitch + rng.uniform(-0.15, 0.15) * pitch
                w = rng.uniform(0.35, 0.6) * pitch
                h = rng.uniform(0.35, 0.6) * pitch
                boxes.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
        init = np.zeros(SAMPLE_DIM, np.float32)
        init[0], init[1] = 1.0, 1.0
        goal = np.zeros(SAMPLE_DIM, np.float32)
        goal[0], goal[1] = 19.0, 19.0
        return cls(init=init, goal=goal,
                   obstacles=np.asarray(boxes, np.float32))

    def padded_obstacles(self, max_obstacles: int,
                         pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Pad the obstacle set to a static shape; returns (boxes, valid_mask).

        Padding boxes are degenerate (max < min) so they can never overlap
        anything, which lets the collision kernel skip masking entirely.

        The static shape is the smallest multiple of 8 that holds the actual
        count (capped at ``max_obstacles``), NOT ``max_obstacles`` itself:
        the fused kernels' per-step obstacle test is O(padded rows), and the
        reference's loop is O(actual count) (collisionCheck.cu:16-28) — on
        the 5-obstacle demo padding to the config max of 32 would do 4x the
        collision work of padding to 8. Rounding to 8 bounds recompiles to
        one per obstacle-count octave. ``pad_to`` overrides for callers that
        batch scenarios with differing counts under one trace.
        """
        k = self.obstacles.shape[0]
        if k > max_obstacles:
            raise ValueError(f"{k} obstacles > max_obstacles={max_obstacles}")
        if pad_to is None:
            pad_to = min(max_obstacles, max(8, -(-k // 8) * 8))
        if pad_to < k:
            raise ValueError(f"pad_to={pad_to} < {k} obstacles")
        pad = np.zeros((pad_to - k, 4), np.float32)
        pad[:, 0:2] = 1.0  # min = 1, max = 0 -> empty box
        boxes = np.concatenate([self.obstacles, pad], axis=0)
        mask = np.zeros(pad_to, bool)
        mask[:k] = True
        return boxes, mask


def default_obstacles() -> np.ndarray:
    """The 5 AABBs of configurations/obstacles/obstacles.csv, inlined so the
    demo scenario works without the reference checkout present."""
    return np.array(
        [
            [2.0, 2.0, 4.0, 4.0],
            [7.0, 2.0, 9.0, 5.0],
            [3.0, 18.0, 6.0, 20.0],
            [2.0, 10.0, 4.0, 12.0],
            [0.0, 6.0, 18.0, 8.0],
        ],
        dtype=np.float32,
    )
