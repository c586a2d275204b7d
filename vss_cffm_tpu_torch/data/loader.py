"""Prefetching loaders: train batches and eval items, decoded on threads or
in spawned processes.

The port's copy of ``vss_cffm_tpu/data/loader.py``. ``TrainLoader`` yields
endless shuffled batches of train clips, its items made on a pool of threads
(the native library and numpy release the GIL in their loops) or of spawned
worker processes; the eval loaders decode the next ``prefetch`` items on a
pool of threads while the caller runs the current one and yield them in
index order.

Determinism: the sample RNG of a train item is ``RandomState`` from
``(seed, epoch, index)``, so a run gives the same batches whatever the
workers' timing or kind (the intent of the reference's seeded
``worker_init_fn``, ``mmseg/datasets/builder.py:160-177``).
"""

from __future__ import annotations

import collections
import os
import queue
import secrets
import threading
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context, shared_memory
from typing import Iterator

import numpy as np
import torch

from .. import native

__all__ = ["TrainLoader", "iterate_eval", "iterate_eval_tta", "prefetch_map"]


def _sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.PCG64(np.random.SeedSequence([seed, epoch, index])))


# ---- process workers: the dataset handed over once, items back through POSIX
# shared memory (one segment an item, named by the loader's prefix)

_WORKER: dict = {}


def _worker_init(dataset, prefix: str) -> None:
    _WORKER.update(dataset=dataset, prefix=prefix)


def _worker_item(seed: int, epoch: int, idx: int, normalize: bool) -> tuple:
    """Make one train item in a worker and leave it in a new shared-memory
    segment; returns (segment name, imgs shape, dtype, labels shape, dtype,
    video). The segment stays registered with the resource tracker that the
    parent shares, so the parent's unlink is its one release."""
    item = _WORKER["dataset"].get_train_item(idx, _sample_rng(seed, epoch, idx), normalize)
    imgs, labels = np.ascontiguousarray(item["imgs"]), np.ascontiguousarray(item["labels"])
    shm = shared_memory.SharedMemory(name=f"{_WORKER['prefix']}_{epoch}_{idx}", create=True,
                                     size=imgs.nbytes + labels.nbytes)
    try:
        np.ndarray(imgs.shape, imgs.dtype, buffer=shm.buf)[...] = imgs
        np.ndarray(labels.shape, labels.dtype, buffer=shm.buf, offset=imgs.nbytes)[...] = labels
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    shm.close()
    return shm.name, imgs.shape, imgs.dtype.str, labels.shape, labels.dtype.str, item["video"]


def _segment_item(seg: shared_memory.SharedMemory, meta: tuple) -> dict:
    """An item's arrays as views of its segment."""
    _, ishape, idt, lshape, ldt, video = meta
    imgs = np.ndarray(ishape, np.dtype(idt), buffer=seg.buf)
    labels = np.ndarray(lshape, np.dtype(ldt), buffer=seg.buf, offset=imgs.nbytes)
    return {"imgs": imgs, "labels": labels, "video": video}


def _release(fut: Future) -> None:
    """Wait for a process worker's future and unlink the segment it made; a
    future that failed or was cancelled made none."""
    if fut.cancelled() or fut.exception() is not None:
        return
    seg = shared_memory.SharedMemory(name=fut.result()[0])
    seg.close()
    seg.unlink()


class TrainLoader:
    """Endless shuffled clip batches on ``device``: {"imgs": (B, T, H, W, 3)
    f32, or uint8 BGR with ``device_normalize``; "labels": (B, T, H, W)
    int32; "videos": names}.

    - one permutation of the videos an epoch (``RandomState(seed + epoch)``),
      every ``num_shards``-th from ``shard_id`` (as ``DistributedSampler``
      splits them over ranks), only full batches (drop-last);
    - ``num_workers=0`` loads each batch in the caller; ≥ 1 loads items on
      that many workers (clamped to the core count) behind a queue of
      ``prefetch`` batches: threads (``worker_mode="thread"``), or processes
      (``"process"``: spawned, never forked, as the parent holds a CUDA
      context; the dataset is handed to each once and must pickle; the
      native library is built in the parent first; each item comes back in a
      shared-memory segment, copied once into the batch and unlinked);
    - each batch is assembled in one copy an item, into pinned host memory on
      a CUDA ``device``, and goes there with ``non_blocking=True``;
    - a worker's exception is raised in the caller. Closing the iterator
      (or an error) cancels the items not started, unlinks the segments of
      those that ran, stops the workers and joins the producer thread."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, shard_id: int = 0, num_shards: int = 1,
                 device_normalize: bool = False, worker_mode: str = "thread",
                 device: str | torch.device = "cuda"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode={worker_mode!r}: 'thread' or 'process'")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainLoader: no CUDA device is present; pass device='cpu'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        if num_workers > 0:
            num_workers = min(num_workers, max(1, os.cpu_count() or 1))
        self.num_workers = num_workers
        self.worker_mode = worker_mode
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
        """The batch's tensors, each item's arrays copied once into them (page-
        locked on a CUDA device)."""
        pin = self.device.type == "cuda"
        out = {"videos": [b["video"] for b in items]}
        for key in ("imgs", "labels"):
            first = items[0][key]
            t = torch.empty((len(items), *first.shape), dtype=torch.from_numpy(first[:0]).dtype,
                            pin_memory=pin)
            dst = t.numpy()
            for j, b in enumerate(items):
                dst[j] = b[key]
            out[key] = t
        return out

    def _process_batch(self, futs: list[Future]) -> dict:
        """The batch of B process workers' futures: each item's segment copied
        once into the batch, then unlinked, whatever happens to the others."""
        segs, metas = [], []
        try:
            for fut in futs:
                metas.append(fut.result())
                segs.append(shared_memory.SharedMemory(name=metas[-1][0]))
            return self._host_batch([_segment_item(seg, meta) for seg, meta in zip(segs, metas)])
        finally:
            for seg in segs:
                seg.unlink()
                try:
                    seg.close()
                except BufferError:  # a view kept by a traceback: its mapping goes with it
                    pass
            for fut in futs[len(segs):]:
                if not fut.cancel():
                    _release(fut)

    def _to_device(self, batch: dict) -> dict:
        if self.device.type == "cpu":
            return batch
        return {**batch, **{k: batch[k].to(self.device, non_blocking=True)
                            for k in ("imgs", "labels")}}

    def _pool(self):
        if self.worker_mode == "thread":
            return ThreadPoolExecutor(self.num_workers)
        native.available()  # build the native library once, before the workers load it
        return ProcessPoolExecutor(self.num_workers, mp_context=get_context("spawn"),
                                   initializer=_worker_init,
                                   initargs=(self.dataset, f"vssl_{os.getpid()}_"
                                             f"{secrets.token_hex(4)}"))

    def __iter__(self) -> Iterator[dict]:
        stream = self._index_stream()
        if self.num_workers == 0:
            while True:
                items = [self._item(*next(stream)) for _ in range(self.batch_size)]
                yield self._to_device(self._host_batch(items))
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        process = self.worker_mode == "process"

        def put(obj) -> None:
            while not stop.is_set():
                try:
                    out_q.put(obj, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                with self._pool() as pool:
                    pending: collections.deque = collections.deque()
                    try:
                        while not stop.is_set():
                            while len(pending) < self.batch_size * 2:
                                epoch, idx = next(stream)
                                if process:
                                    pending.append(pool.submit(
                                        _worker_item, self.seed, epoch, idx,
                                        not self.device_normalize))
                                else:
                                    pending.append(pool.submit(self._item, epoch, idx))
                            futs = [pending.popleft() for _ in range(self.batch_size)]
                            if process:
                                put(self._process_batch(futs))
                            else:
                                put(self._host_batch([f.result() for f in futs]))
                    finally:
                        for fut in pending:  # wait for the items that run: unlink theirs
                            if not fut.cancel() and process:
                                _release(fut)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                yield self._to_device(item)
        finally:
            # the producer ends after its items in flight; waiting for it keeps
            # a closed loader from decoding on while its caller (or the
            # interpreter) goes on and tears down what the items read
            stop.set()
            thread.join()


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
