"""Data parallelism over processes, and a clip's frames over ranks (``mesh.py``)."""

from .mesh import (LOCAL_RANK_ENV, RANK_ENV, ClipMesh, DrawShard, add_arguments, all_gather_cat,
                   all_reduce_mean_, all_reduce_sum, barrier, collective_device, create_clip_mesh,
                   free_port, gather_cat, group_size, init_distributed, is_distributed, is_main,
                   options, rank, replicate, shard_batch, shard_clip_batch, shutdown, spawn,
                   world_draws, world_size)

__all__ = ["LOCAL_RANK_ENV", "RANK_ENV", "ClipMesh", "DrawShard", "add_arguments",
           "all_gather_cat", "all_reduce_mean_", "all_reduce_sum", "barrier",
           "collective_device", "create_clip_mesh", "free_port", "gather_cat", "group_size",
           "init_distributed", "is_distributed", "is_main", "options", "rank", "replicate",
           "shard_batch", "shard_clip_batch", "shutdown", "spawn", "world_draws", "world_size"]
