"""Prefetching eval loaders: items decoded on a thread pool, in order.

The port's copy of the eval half of ``vss_cffm_tpu/data/loader.py``: a pool
of threads decodes the next ``prefetch`` items while the caller runs the
current one (PIL releases the GIL while it decodes), and yields them in
index order. The train loader is not ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

__all__ = ["iterate_eval", "iterate_eval_tta", "prefetch_map"]


def prefetch_map(fn, indices, num_workers: int = 4, prefetch: int = 8) -> Iterator:
    """Yield ``fn(i)`` for each index, keeping ``prefetch`` results in flight
    on a thread pool (order kept). ``num_workers=0`` maps synchronously in
    the caller."""
    indices = list(indices)
    if num_workers == 0:
        for i in indices:
            yield fn(i)
        return
    with ThreadPoolExecutor(num_workers) as pool:
        pending = []
        it = iter(indices)
        for _ in range(min(prefetch, len(indices))):
            pending.append(pool.submit(fn, next(it)))
        while pending:
            item = pending.pop(0).result()
            try:
                pending.append(pool.submit(fn, next(it)))
            except StopIteration:
                pass
            yield item


def iterate_eval(dataset, num_workers: int = 4, prefetch: int = 8, shard_id: int = 0,
                 num_shards: int = 1) -> Iterator[dict]:
    """Test items (one clip per frame) of ``dataset``, prefetched; every
    ``num_shards``-th from ``shard_id``."""
    return prefetch_map(dataset.get_test_item, range(shard_id, len(dataset), num_shards),
                        num_workers, prefetch)


def iterate_eval_tta(dataset, num_workers: int = 4, prefetch: int = 4, shard_id: int = 0,
                     num_shards: int = 1) -> Iterator[dict]:
    """Multi-scale / flip test items (``--aug-test``), prefetched."""
    return prefetch_map(dataset.get_test_item_tta, range(shard_id, len(dataset), num_shards),
                        num_workers, prefetch)
