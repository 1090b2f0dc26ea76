from cudasbmp_jax.geometry.aabb import segment_aabb, segment_clear, segments_clear_batch
from cudasbmp_jax.geometry.grid import RegionGrid, OccupancyGrid

__all__ = [
    "segment_aabb",
    "segment_clear",
    "segments_clear_batch",
    "RegionGrid",
    "OccupancyGrid",
]
