from cudasbmp_jax.parallel.mesh import make_planner_mesh, device_count
from cudasbmp_jax.parallel.multi_query import MultiQueryPlanner
from cudasbmp_jax.parallel.batch_kgmt import ArenaMultiQueryPlanner
from cudasbmp_jax.parallel.monte_carlo import MonteCarloPlanner, random_scenarios
from cudasbmp_jax.parallel.sharded_tree import ShardedTreePlanner
from cudasbmp_jax.parallel.sharded_multi_query import ShardedMultiQueryPlanner
from cudasbmp_jax.parallel.streaming_mc import StreamingMonteCarloPlanner

__all__ = [
    "make_planner_mesh",
    "device_count",
    "MultiQueryPlanner",
    "ArenaMultiQueryPlanner",
    "MonteCarloPlanner",
    "random_scenarios",
    "ShardedTreePlanner",
    "ShardedMultiQueryPlanner",
    "StreamingMonteCarloPlanner",
]
