"""Train a CFFM segmentor of the port from an experiment config.

The port of the JAX package's ``tools/train.py`` (the explicit loop that
replaces mmcv's IterBasedRunner and its hooks, reference ``tools/train.py``
and ``mmseg/apis/train.py``)::

    python -m vss_cffm_tpu_torch.tools.train vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py \\
        [--work-dir DIR] [--load-from CKPT] [--resume-from CKPT_DIR] [--seed N] \\
        [--eval-interval N] [--profile-dir DIR] [--device cuda|cuda:N|cpu] \\
        [--distributed [--backend nccl|gloo] [--coordinator HOST:PORT --num-processes N
        --process-id R]] [--options data.batch_size=2 optim.max_iters=4 ...]

One process on one device (``--device``, the card unless ``cpu`` is asked
for; without a card ``cuda`` raises), or, with ``--distributed``, one
process a rank (``tools/dist_train.sh``, torchrun's environment, or the
coordinator flags; ``parallel.init_distributed``: NCCL on the card, one
rank a card, ``cuda:N`` and ``--backend gloo`` to put every rank on card
N; gloo on the CPU). ``cfg.data.batch_size`` is the global batch: each
rank loads ``batch_size // world`` clips of its shard of the videos, and
the step computes what one process computes on the global batch
(``train/step.py``). Every rank starts from rank 0's weights
(``parallel.replicate``); rank 0 logs and writes the checkpoints. The loop:

- ``VSPWVideoDataset`` (train split) and ``TrainLoader`` with uint8 batches,
  normalised on the device by the train step;
- the model in ``cfg.bf16``'s compute dtype with f32 parameters, random
  weights from the seed; ``TrainState`` and ``make_train_step``; step ``it``
  draws its dropout and drop-path masks from a generator seeded from
  ``(seed + 1, it)`` (JAX: ``fold_in(PRNGKey(seed + 1), it)``);
- ``--resume-from`` a checkpoint directory restores weights, optimizer
  moments, schedule and step; ``--load-from`` overlays weights only: a
  ``.pth`` / ``.pt`` of the reference's names (a whole segmentor, or a
  ``mit_bX.pth`` backbone without prefix, loaded under ``backbone.`` with
  its ImageNet ``head.*`` dropped) or a checkpoint directory;
- a log line every ``log_interval`` steps; a checkpoint every
  ``checkpoint_interval`` steps and at ``max_iters`` (``work_dir/ckpt``,
  with classes, palette and config in its metadata); the val mIoU every
  ``--eval-interval`` steps (``ClipEvaluator``, each rank a shard of the
  frames, the confusions summed); with ``--profile-dir``, a
  ``torch.profiler`` trace of iterations 10-13;
- CFFM++ finetune (``model.head.mode="finetune"``, the ``*_finetune_40k``
  configs, ``--load-from`` a CFFM checkpoint): a ``ClusterStore`` of
  ``cfg.cluster_dir`` (phase A's ``tools/generate_prototypes``) hands each
  step the centres of its batch's videos, and the interval eval the
  centres of each val video.

The loader starts again from epoch 0 on resume, as the JAX loop does.
``train(...)`` is the loop without the argument parsing, for callers in
the same process.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import parallel
from ..config import ExperimentConfig, apply_overrides, load_config
from ..data import TrainLoader, VSPWVideoDataset, iterate_eval
from ..data.palette import VSPW_CLASSES, VSPW_PALETTE
from ..eval.prototypes import ClusterStore
from ..models import CFFMSegmentor
from ..train import CheckpointManager, TrainState, make_train_step, poly_schedule
from ..utils.logging import get_logger

__all__ = ["build_parser", "main", "train", "step_seed", "PROFILE_FIRST", "PROFILE_LAST"]

PROFILE_FIRST, PROFILE_LAST = 10, 13  # iterations traced with --profile-dir


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train a CFFM segmentor of the port.")
    ap.add_argument("config")
    ap.add_argument("--work-dir")
    ap.add_argument("--load-from")
    ap.add_argument("--resume-from")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="val mIoU every N iters (0: none; the reference's EvalHook)")
    ap.add_argument("--profile-dir",
                    help=f"write a torch.profiler trace of iterations "
                         f"{PROFILE_FIRST}-{PROFILE_LAST} here")
    parallel.add_arguments(ap)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the rank's own card), cuda:N (every rank on card N) "
                         "or cpu")
    ap.add_argument("--options", nargs="*", default=[])
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.options)
    return train(cfg, work_dir=args.work_dir or cfg.work_dir, device=args.device,
                 seed=args.seed, load_from=args.load_from or cfg.load_from,
                 resume_from=args.resume_from or cfg.resume_from,
                 eval_interval=args.eval_interval, profile_dir=args.profile_dir,
                 distributed=parallel.options(args))


def step_seed(seed: int, it: int) -> int:
    """The seed of step ``it``'s generator, from ``(seed + 1, it)``."""
    return int(np.random.SeedSequence([seed + 1, it]).generate_state(1, np.uint64)[0])


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device is present; pass --device cpu to train on "
                           "the CPU")
    return device


def _load_weights(model: CFFMSegmentor, src: str, logger) -> None:
    """``--load-from``: a reference ``.pth`` / ``.pt`` or a checkpoint
    directory, overlaid with strict=False semantics; the model's own values
    survive where the source has none."""
    if src.endswith((".pth", ".pt")):
        from ..utils.weights import load_torch_state_dict

        sd = load_torch_state_dict(src)
        if not any(k.startswith("decode_head.") for k in sd):
            # a backbone alone (mit_bX.pth): no prefix, and an ImageNet head
            sd = {f"backbone.{k}": v for k, v in sd.items() if not k.startswith("head.")}
        kept = model.load_state_dict(sd, strict=False).missing_keys
        logger.info(f"warm-started from PyTorch checkpoint {src}")
    else:
        kept = CheckpointManager(src).load_params(model)
        logger.info(f"warm-started params from checkpoint {src}")
    logger.info(f"kept {len(kept)} tensors of the init: {kept}")


def _device_busy_ms(prof) -> float:
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3


def train(cfg: ExperimentConfig, *, work_dir: str, device: str | torch.device = "cuda",
          seed: int | None = None, load_from: str | None = None,
          resume_from: str | None = None, eval_interval: int = 0,
          profile_dir: str | None = None, dataset=None,
          distributed: dict | None = None) -> dict:
    """Train ``cfg`` up to ``cfg.optim.max_iters``; ``dataset`` replaces the
    train split of ``cfg.data.data_root``. ``distributed``, a dict of
    ``parallel.init_distributed``'s keywords but the device (``backend``,
    ``coordinator``, ``num_processes``, ``process_id``; ``{}`` for torchrun's
    environment and the default backend), starts a process group on
    ``device`` and ends it on return; with None the loop runs over the group
    the caller started, if any. Returns {"state", "steps": one dict a step (step, loss_seg,
    acc_seg, grad_norm, lr of the groups without a multiplier; the global
    batch's), "evals", "checkpoints" (steps saved), "iter_ms" (host ms an
    iteration of each log window, the loader's wait included), "profile"
    (iterations traced, device busy ms or None on the CPU)}."""
    if cfg.model.arch != "cffm":
        raise ValueError(f"train: the config's model has arch={cfg.model.arch!r}; the train "
                         "step trains clip models only (the JAX step cannot train an image "
                         "model either)")
    if distributed is None:
        return _train(cfg, work_dir, _device(device), seed, load_from, resume_from,
                      eval_interval, profile_dir, dataset)
    device = parallel.init_distributed(device, **distributed)
    try:
        return _train(cfg, work_dir, device, seed, load_from, resume_from, eval_interval,
                      profile_dir, dataset)
    finally:
        parallel.shutdown()


def _train(cfg: ExperimentConfig, work_dir: str, device: torch.device, seed: int | None,
           load_from: str | None, resume_from: str | None, eval_interval: int,
           profile_dir: str | None, dataset) -> dict:
    rank, world = parallel.rank(), parallel.world_size()
    if cfg.data.batch_size % world:
        raise ValueError(f"train: data.batch_size {cfg.data.batch_size} (the global batch) "
                         f"does not divide by {world} ranks")
    logger = get_logger(work_dir)
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                       if device.type == "cuda" else "")
                + (f"; rank {rank} of {world}, {cfg.data.batch_size // world} of the "
                   f"{cfg.data.batch_size} clips a step" if world > 1 else ""))
    logger.info(f"config: {cfg}")
    seed = cfg.seed if seed is None else seed

    if dataset is None:
        dataset = VSPWVideoDataset(cfg.data.data_root, "train", dilation=cfg.data.dilation,
                                   crop_size=cfg.data.crop_size, img_scale=cfg.data.img_scale)
    loader = TrainLoader(dataset, cfg.data.batch_size // world, seed=seed,
                         num_workers=cfg.data.num_workers, shard_id=rank, num_shards=world,
                         device_normalize=True, device=device)

    store = ClusterStore(cfg.cluster_dir) if cfg.model.head.mode == "finetune" else None
    model = CFFMSegmentor(cfg.model, dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device).train()
    count = lambda prefix: sum(p.numel() for n, p in model.named_parameters()
                               if n.startswith(prefix))
    logger.info(f"params: total {count(''):,} | backbone {count('backbone.'):,} | "
                f"head {count('decode_head.'):,}")

    state = TrainState.create(model, cfg.optim)
    ckpt = CheckpointManager(os.path.join(work_dir, "ckpt"))
    if resume_from:
        state = CheckpointManager(resume_from).restore(state)
        logger.info(f"resumed from step {state.step}")
    elif load_from:
        _load_weights(model, load_from, logger)
    parallel.replicate(model)
    step_fn = make_train_step(model, state.optimizer, state.scheduler)
    schedule = poly_schedule(cfg.optim)
    # a group without an lr multiplier: its lr is the schedule's
    base_group = next(g for g in state.optimizer.param_groups
                      if g["initial_lr"] == cfg.optim.lr)

    out = {"state": state, "steps": [], "evals": [], "checkpoints": [], "iter_ms": [],
           "profile": None}
    frames = cfg.data.batch_size * (len(cfg.data.dilation) + 1)
    start = state.step
    window, prof, val_ds, val_eval = [], None, None, None
    batches = iter(loader)
    t0 = time.time()
    try:
        for it in range(start, cfg.optim.max_iters):
            batch = next(batches)
            if store is not None:
                batch["cluster_centers"] = store.on_device(batch["videos"], device)
            gen = torch.Generator(device).manual_seed(step_seed(seed, it))
            window.append((it, base_group["lr"], step_fn(batch, gen)))

            if (it + 1) % cfg.log_interval == 0:
                rows = [{"step": i + 1, "lr": r, **{k: v.item() for k, v in m.items()}}
                        for i, r, m in window]
                out["steps"] += rows
                dt = (time.time() - t0) / len(rows)
                out["iter_ms"].append(dt * 1e3)
                loss = float(np.mean([r["loss_seg"] for r in rows]))
                acc = float(np.mean([r["acc_seg"] for r in rows]))
                logger.info(f"iter [{it + 1}/{cfg.optim.max_iters}] lr {schedule(it):.3e} "
                            f"loss {loss:.4f} acc_seg {acc:.2f} time {dt:.3f}s/iter "
                            f"({frames / dt:.1f} frames/s)")
                window, t0 = [], time.time()

            if profile_dir and it == start + PROFILE_FIRST - 1:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if prof is not None and it == start + PROFILE_LAST:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                busy = _device_busy_ms(prof) if device.type == "cuda" else None
                with open(os.path.join(profile_dir, "key_averages.txt"), "w") as fh:
                    fh.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                                       row_limit=100))
                n = PROFILE_LAST - PROFILE_FIRST + 1
                out["profile"] = {"iterations": n, "device_busy_ms": busy}
                logger.info(f"profiler trace of iterations {PROFILE_FIRST}-{PROFILE_LAST} "
                            f"written to {profile_dir}; device busy "
                            + (f"{busy / n:.3f} ms a step" if busy is not None
                               else "not measured (no card)"))
                prof = None

            if eval_interval and (it + 1) % eval_interval == 0:
                if val_eval is None:
                    from ..eval import ClipEvaluator

                    val_ds = VSPWVideoDataset(cfg.data.data_root, "val",
                                              dilation=cfg.data.dilation,
                                              img_scale=cfg.data.img_scale)
                    val_eval = ClipEvaluator(model, cfg.model.head.num_classes, device=device,
                                             cluster_store=store)
                model.eval()
                val_eval.reset()
                val_eval.run(iterate_eval(val_ds, num_workers=cfg.data.num_workers,
                                          shard_id=rank, num_shards=world), dataset=val_ds)
                val_eval.aggregate_across_processes()
                m = val_eval.summary()
                model.train()
                out["evals"].append({"step": it + 1, **m})
                logger.info(f"eval @ {it + 1}: mIoU {m['mIoU']:.4f} "
                            f"mIoU_seen {m['mIoU_seen']:.4f} FWIoU {m['FWIoU']:.4f}")

            if (it + 1) % cfg.checkpoint_interval == 0 or (it + 1) == cfg.optim.max_iters:
                ckpt.save(state, metadata={"classes": list(VSPW_CLASSES),
                                           "palette": [list(p) for p in VSPW_PALETTE],
                                           "config": cfg})
                out["checkpoints"].append(it + 1)
                logger.info(f"saved checkpoint at iter {it + 1}")
    finally:
        if prof is not None:
            prof.stop()
        batches.close()
    if window:  # steps after the last log line
        out["steps"] += [{"step": i + 1, "lr": r, **{k: v.item() for k, v in m.items()}}
                         for i, r, m in window]
    return out


if __name__ == "__main__":
    main()
