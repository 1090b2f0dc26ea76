from cudasbmp_jax.ops.rollout import rollout_batch, propagate_and_check
from cudasbmp_jax.ops.compaction import compact_indices
from cudasbmp_jax.ops.segments import (
    masked_bincount,
    masked_multi_bincount,
    scatter_or,
)

__all__ = [
    "rollout_batch",
    "propagate_and_check",
    "compact_indices",
    "masked_bincount",
    "masked_multi_bincount",
    "scatter_or",
]
