"""Data parallelism over processes: the port's counterpart of
``vss_cffm_tpu/parallel/mesh.py``.

The JAX package shards the batch over one ``data`` mesh axis and lets GSPMD
insert every reduction across devices (the gradient sum, the fuse BN's
batch moments, the OHEM threshold, the confusion sum). Here each process
(a "rank") holds ``batch_size // world`` clips of the global batch and the
reductions are explicit ``torch.distributed`` collectives:

- ``init_distributed`` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or the JAX CLI's ``--coordinator`` / ``--num-processes``
  / ``--process-id``: NCCL on the card, gloo on the CPU (or, asked for, gloo
  on the card, which lets several ranks share one card);
- ``shard_batch`` takes the rank's rows of a global batch, ``replicate``
  broadcasts rank 0's parameters and buffers;
- ``all_reduce_mean_`` averages tensors in place through one flat buffer
  (the gradients), ``all_reduce_sum`` is the differentiable sum (its
  backward sums the upstream gradient over the ranks), ``all_gather_cat``
  concatenates equal-sized tensors of every rank in rank order;
- ``rank``, ``world_size``, ``is_main``, ``barrier`` and ``is_distributed``
  read the group;
- ``add_arguments`` gives a CLI the flags of ``init_distributed`` and
  ``options`` reads them back.

Every collective is the identity in one process without a group, so code
that calls them runs unchanged there; a group of one rank runs them (NCCL
at world 1 runs the same collectives as at world N). ``spawn`` runs a
function on N local ranks (a free port on ``localhost``, processes started
by ``spawn``, so that a child imports only what the function's module
imports) and returns each rank's result.

The contract: while a group is up, the model and the loss reduce over it
(the fuse BN's moments in training, the OHEM threshold, the random masks'
draw, the confusion sum), so every rank must make the same calls in the
same order, each on its own rows: a call that one rank makes alone waits
for the others (or, for a random mask, takes the rows of another draw).
A forward, a loss or an evaluation on one rank's data alone belongs
outside the group, or in a process without one.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "shutdown", "rank", "world_size", "is_main", "barrier",
           "is_distributed", "shard_batch", "replicate", "all_reduce_mean_", "all_reduce_sum",
           "all_gather_cat", "collective_device", "add_arguments", "options", "free_port",
           "spawn", "RANK_ENV"]

RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """Whether a process group is up (of any size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 in one process."""
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    """The number of ranks; 1 in one process."""
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if is_distributed():
        dist.barrier()


def _rank_settings(coordinator: str | None, num_processes: int | None,
                   process_id: int | None) -> tuple[str, int, int, int]:
    """(init_method, world size, rank, local rank) from torchrun's environment,
    else from the coordinator flags; raises naming what is missing."""
    env = {k: os.environ.get(k) for k in RANK_ENV}
    if all(v is not None for v in env.values()):
        return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]), int(env["LOCAL_RANK"]))
    flags = {"--coordinator": coordinator, "--num-processes": num_processes,
             "--process-id": process_id}
    if all(v is not None for v in flags.values()):
        if ":" not in coordinator:
            raise ValueError(f"--coordinator {coordinator!r}: expected host:port")
        return f"tcp://{coordinator}", int(num_processes), int(process_id), int(process_id)
    raise RuntimeError(
        "--distributed needs a rank environment: launch with torchrun (or the port's "
        "tools/dist_train.sh / dist_test.sh), which sets "
        f"{', '.join(RANK_ENV)} (missing: {', '.join(k for k, v in env.items() if v is None)}), "
        "or pass --coordinator host:port --num-processes N --process-id R (missing: "
        f"{', '.join(k for k, v in flags.items() if v is None)})")


def init_distributed(device: str | torch.device = "cuda", backend: str | None = None,
                     coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout: datetime.timedelta | None = None) -> torch.device:
    """Start the process group; returns this rank's device.

    ``device``: "cuda" is ``cuda:LOCAL_RANK``; "cuda:N" pins every rank to
    card N; "cpu". ``backend``: "nccl" or "gloo", by default NCCL on the card
    and gloo on the CPU. NCCL takes one rank a card, so a pinned card under
    NCCL with more than one rank raises; gloo takes CUDA tensors too (through
    the host). Nothing falls back to another device or backend."""
    init_method, world, r, local = _rank_settings(coordinator, num_processes, process_id)
    device = torch.device(device)
    pinned = device.index is not None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is present; pass --device cpu "
                               "to run the ranks on the CPU")
        if device.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"init_distributed: local rank {local} has no card of its "
                                   f"own ({torch.cuda.device_count()} present)")
            device = torch.device("cuda", local)
    elif device.type != "cpu":
        raise ValueError(f"init_distributed: device {device}; expected cuda, cuda:N or cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: backend {backend!r}; expected nccl or gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("init_distributed: NCCL runs on the card only; use gloo on the CPU")
        if world > 1 and pinned:
            raise ValueError(f"init_distributed: {world} ranks pinned to {device} under NCCL, "
                             "which takes one rank a card; use --backend gloo to share a card")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=r,
                            **kwargs)
    return device


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    if is_distributed():
        dist.destroy_process_group()


def collective_device(fallback: torch.device | str = "cpu") -> torch.device:
    """Where a collective's tensors must lie: the current card under NCCL,
    else ``fallback``."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(fallback)


def shard_batch(batch: Any, rank_: int | None = None, world: int | None = None) -> Any:
    """The rank's rows of a global batch (a tensor, an array, or a dict of
    them): rows r·b … (r+1)·b − 1, b = rows // world; the rows must divide
    by the world."""
    r = rank() if rank_ is None else rank_
    n = world_size() if world is None else world
    if isinstance(batch, dict):
        return {k: shard_batch(v, r, n) for k, v in batch.items()}
    rows = len(batch)
    if rows % n:
        raise ValueError(f"shard_batch: a global batch of {rows} rows over {n} ranks")
    b = rows // n
    return batch[r * b:(r + 1) * b]


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, one flat
    buffer a dtype; nothing without a group."""
    if not is_distributed():
        return module
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group]).to(collective_device(group[0].device))
        dist.broadcast(flat, 0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return module


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Average ``tensors`` over the ranks in place, through one flat buffer
    (one all-reduce); their dtypes must agree. Nothing without a group."""
    if not is_distributed() or not tensors:
        return tensors
    n = world_size()
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dev = collective_device(flat.device)
    flat = flat.to(dev)
    dist.all_reduce(flat)
    flat.div_(n)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward sums the
    upstream gradient over the ranks (``torch.distributed.nn``). ``x``
    without a group."""
    if not is_distributed():
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


@torch.no_grad()
def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along dim 0 in
    rank order, without gradient (one all-gather); ``x`` without a group."""
    if not is_distributed():
        return x
    x_ = x.to(collective_device(x.device))
    parts = [torch.empty_like(x_) for _ in range(world_size())]
    dist.all_gather(parts, x_.contiguous())
    return torch.cat(parts).to(x.device)


def add_arguments(parser) -> None:
    """The flags of a CLI that runs over several processes: ``--distributed``
    and ``init_distributed``'s settings (read back by ``options``); the CLI
    keeps its own ``--device``."""
    parser.add_argument("--distributed", action="store_true",
                        help="one process a rank: torchrun's environment (the port's "
                             "tools/dist_*.sh) or the three flags below")
    parser.add_argument("--coordinator", help="rank 0's host:port, without torchrun")
    parser.add_argument("--num-processes", type=int, help="the world size, without torchrun")
    parser.add_argument("--process-id", type=int, help="this process's rank, without torchrun")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="the collectives' backend (default: nccl on the card, gloo on "
                             "the CPU)")


def options(args) -> dict | None:
    """``init_distributed``'s keywords but the device from the flags of
    ``add_arguments``; None without ``--distributed``."""
    if not args.distributed:
        return None
    return dict(backend=args.backend, coordinator=args.coordinator,
                num_processes=args.num_processes, process_id=args.process_id)


# ---- local ranks -------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost (for a coordinator or torchrun's master)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(fn, r: int, world: int, port: int, device: str, backend: str | None,
             args: tuple, results) -> None:
    try:
        dev = init_distributed(device, backend, f"127.0.0.1:{port}", world, r,
                               timeout=datetime.timedelta(seconds=600))
        try:
            # pickled here, whole: torch's queue pickler would hand the parent
            # tensors in shared memory that vanish with this process
            results.put((r, True, pickle.dumps(fn(dev, *args))))
        finally:
            shutdown()
    except Exception:  # the process's boundary: the parent raises it with the trace
        results.put((r, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, *args, device: str = "cuda", backend: str | None = None,
          timeout: float = 900.0) -> list:
    """Run ``fn(device, *args)`` on ``world`` local ranks of a new process
    group (``init_distributed`` with ``device`` and ``backend``: by default
    NCCL and each rank's own card; "cpu" asks for gloo on the CPU), each in a
    process started by ``spawn``; returns the ranks' results in rank order.
    ``fn`` and ``args`` must pickle (``fn`` by its module's import path). A
    rank that raises makes this raise with its traceback; the other ranks
    are then killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned, args=(fn, r, world, port, device, backend, args,
                                                 results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(out) < world:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                gone = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in out]
                if gone:
                    raise RuntimeError(f"spawn: rank {gone[0]} exited with code "
                                       f"{procs[gone[0]].exitcode}") from None
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {r} raised:\n{value}")
            out[r] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
