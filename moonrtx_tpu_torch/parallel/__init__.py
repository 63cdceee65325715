"""Multi-device rendering over an explicit device list: image strips,
the phi-wedge shadow scan, and heightfield band sharding (per-device
memory scaling for maps bigger than one device)."""

from moonrtx_tpu_torch.parallel.mesh import (
    TILE_AXIS,
    Mesh,
    all_gather,
    broadcast,
    make_mesh,
    reduce_scatter,
    replicated,
    row_sharded,
)
from moonrtx_tpu_torch.parallel.hfshard import (
    BAND_HALO,
    band_heights,
    render_burst_pallas_hfshard,
    shard_bands,
)
from moonrtx_tpu_torch.parallel.tiles import (
    build_shadow_map_sharded,
    render_accumulate_sharded,
    render_burst_pallas_sharded,
    render_frame_sharded,
    render_pose_sharded,
    render_timestep_sharded,
)

__all__ = [
    "TILE_AXIS", "make_mesh", "replicated", "row_sharded",
    "render_frame_sharded", "build_shadow_map_sharded",
    "render_burst_pallas_sharded",
    "render_pose_sharded", "render_timestep_sharded",
    "render_accumulate_sharded",
    "BAND_HALO", "band_heights", "shard_bands",
    "render_burst_pallas_hfshard",
    "Mesh", "all_gather", "reduce_scatter", "broadcast",
]
