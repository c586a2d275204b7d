"""Data parallelism over processes (``mesh.py``)."""

from .mesh import (RANK_ENV, add_arguments, all_gather_cat, all_reduce_mean_, all_reduce_sum,
                   barrier, collective_device, free_port, init_distributed, is_distributed,
                   is_main, options, rank, replicate, shard_batch, shutdown, spawn, world_size)

__all__ = ["RANK_ENV", "add_arguments", "all_gather_cat", "all_reduce_mean_", "all_reduce_sum",
           "barrier", "collective_device", "free_port", "init_distributed", "is_distributed",
           "is_main", "options", "rank", "replicate", "shard_batch", "shutdown", "spawn",
           "world_size"]
