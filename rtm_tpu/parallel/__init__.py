"""Multi-chip / multi-host execution (sharding, collectives, distributed init).

The reference has no distributed layer at all (SURVEY.md §2.1, §5.8 — its
only transport is single-queue Vulkan submission).  This package is the
replacement: shard_map data parallelism over the pixel grid,
sample-axis sharding, and psum-reduced scene-parameter gradients.
"""
from .distributed import initialize_distributed
from .sharding import (DP_AXIS, make_mesh, make_train_step, render_sharded,
                       render_sharded_spp, sharded_loss_and_grad)

__all__ = [
    "DP_AXIS", "make_mesh", "make_train_step", "render_sharded",
    "render_sharded_spp", "sharded_loss_and_grad", "initialize_distributed",
]
