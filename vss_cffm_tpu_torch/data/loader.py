"""Prefetching loaders: train batches and eval items, decoded on threads.

The port's copy of ``vss_cffm_tpu/data/loader.py``. ``TrainLoader`` yields
endless shuffled batches of train clips; the eval loaders decode the next
``prefetch`` items on a pool of threads while the caller runs the current
one (PIL and numpy release the GIL in their loops) and yield them in index
order.

Determinism: the sample RNG of a train item is ``RandomState`` from
``(seed, epoch, index)``, so a run gives the same batches whatever the
threads' timing (the intent of the reference's seeded ``worker_init_fn``,
``mmseg/datasets/builder.py:160-177``).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

__all__ = ["TrainLoader", "iterate_eval", "iterate_eval_tta", "prefetch_map"]


def _sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.PCG64(np.random.SeedSequence([seed, epoch, index])))


class TrainLoader:
    """Endless shuffled clip batches on ``device``: {"imgs": (B, T, H, W, 3)
    f32, or uint8 BGR with ``device_normalize``; "labels": (B, T, H, W)
    int32; "videos": names}.

    - one permutation of the videos an epoch (``RandomState(seed + epoch)``),
      every ``num_shards``-th from ``shard_id`` (as ``DistributedSampler``
      splits them over ranks), only full batches (drop-last);
    - ``num_workers=0`` loads each batch in the caller; ≥ 1 loads items on
      that many threads (clamped to the core count) behind a queue of
      ``prefetch`` batches;
    - on a CUDA ``device`` a batch goes from pinned host memory with
      ``non_blocking=True``; on the CPU the tensors share the numpy arrays.

    ``worker_mode="process"`` (the JAX package's spawned workers with
    shared-memory transport) is not ported and raises."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, shard_id: int = 0, num_shards: int = 1,
                 device_normalize: bool = False, worker_mode: str = "thread",
                 device: str | torch.device = "cuda"):
        if worker_mode != "thread":
            raise NotImplementedError(f"worker_mode={worker_mode!r}: the port loads on threads "
                                      "only ('thread'); the process pool is not ported")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainLoader: no CUDA device is present; pass device='cpu'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        if num_workers > 0:
            num_workers = min(num_workers, max(1, os.cpu_count() or 1))
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.device_normalize = device_normalize

    def _index_stream(self) -> Iterator[tuple[int, int]]:
        epoch = 0
        n = len(self.dataset)
        while True:
            order = np.random.RandomState(self.seed + epoch).permutation(n)
            order = order[self.shard_id::self.num_shards]
            usable = len(order) - len(order) % self.batch_size
            for i in order[:usable]:
                yield epoch, int(i)
            epoch += 1

    def _item(self, epoch: int, idx: int) -> dict:
        return self.dataset.get_train_item(idx, _sample_rng(self.seed, epoch, idx),
                                           not self.device_normalize)

    def _host_batch(self, items: list[dict]) -> dict:
        pin = self.device.type == "cuda"
        out = {"videos": [b["video"] for b in items]}
        for key in ("imgs", "labels"):
            t = torch.from_numpy(np.stack([b[key] for b in items]))
            out[key] = t.pin_memory() if pin else t
        return out

    def _to_device(self, batch: dict) -> dict:
        if self.device.type == "cpu":
            return batch
        return {**batch, **{k: batch[k].to(self.device, non_blocking=True)
                            for k in ("imgs", "labels")}}

    def __iter__(self) -> Iterator[dict]:
        stream = self._index_stream()
        if self.num_workers == 0:
            while True:
                items = [self._item(*next(stream)) for _ in range(self.batch_size)]
                yield self._to_device(self._host_batch(items))
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = []
                    while not stop.is_set():
                        while len(pending) < self.batch_size * 2:
                            pending.append(pool.submit(self._item, *next(stream)))
                        items = [pending.pop(0).result() for _ in range(self.batch_size)]
                        batch = self._host_batch(items)
                        while not stop.is_set():
                            try:
                                out_q.put(batch, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                    for fut in pending:
                        fut.cancel()
            except Exception as e:  # handed to the consumer, which raises it
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                yield self._to_device(item)
        finally:
            stop.set()


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
