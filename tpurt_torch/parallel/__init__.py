"""Multi-device rendering: spp and image-tile sharding over a device mesh."""

from tpurt_torch.parallel.shard import (
    ShardedRenderer,
    make_mesh,
    render_sample_sharded,
    render_sample_stats_sharded,
)

__all__ = ["ShardedRenderer", "make_mesh", "render_sample_sharded",
           "render_sample_stats_sharded"]
