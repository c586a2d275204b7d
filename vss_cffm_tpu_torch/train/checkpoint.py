"""Checkpoints of the train state with a JSON metadata side file.

The port's copy of ``vss_cffm_tpu/train/checkpoint.py`` (reference surface:
mmcv's ``CheckpointHook`` puts the config text and CLASSES / PALETTE in
``meta``, ``tools/train.py:167-174``), with ``torch.save`` in place of
orbax. A directory holds ``ckpt_{step}.pt`` (the model's, the optimizer's
and the scheduler's ``state_dict`` and the step) and, when given,
``metadata_{step}.json`` (the metadata through ``_config_to_jsonable``,
dataclasses as dicts); the oldest checkpoints past ``max_to_keep`` are
deleted with their metadata. ``restore`` is ``--resume-from`` (model,
optimizer, schedule and step); ``load_params`` is ``--load-from`` (the
model's weights only, overlaid with strict=False semantics).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

import torch
import torch.nn as nn

from .. import parallel
from .state import TrainState

__all__ = ["CheckpointManager"]

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def _config_to_jsonable(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _config_to_jsonable(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, dict):
        return {k: _config_to_jsonable(v) for k, v in cfg.items()}
    if isinstance(cfg, (tuple, list)):
        return [_config_to_jsonable(v) for v in cfg]
    return cfg


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"metadata_{step}.json")

    def steps(self) -> list[int]:
        """The steps of the checkpoints in the directory, ascending."""
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.match(f)))

    def save(self, state: TrainState, metadata: dict | None = None) -> None:
        """Write the state at its step (rank 0 only), then prune to
        ``max_to_keep``; every rank waits until it is written (a barrier), so
        that none reads a checkpoint before it exists."""
        if parallel.is_main():
            self._write(state, metadata)
        parallel.barrier()

    def _write(self, state: TrainState, metadata: dict | None) -> None:
        step = int(state.step)
        tmp = self._path(step) + ".tmp"
        torch.save({"step": step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict()}, tmp)
        os.replace(tmp, self._path(step))
        if metadata is not None:
            with open(self._meta_path(step), "w") as f:
                json.dump(_config_to_jsonable(metadata), f)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
            if os.path.exists(self._meta_path(old)):
                os.remove(self._meta_path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load(self, step: int | None) -> dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=False)

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Full resume into ``state`` (≙ ``--resume-from``): the model's
        weights, the optimizer's moments and the step. As in the JAX package,
        where the checkpoint holds the optimizer's state and count and the
        schedule is the current config's, the hyperparameters stay those
        ``state`` was built with (lr, betas, decay; the schedule's lr at the
        restored step, e.g. after ``optim.max_iters`` is raised)."""
        ckpt = self._load(step)
        state.model.load_state_dict(ckpt["model"], strict=True)
        opt, sched = state.optimizer, state.scheduler
        hyper = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
        opt.load_state_dict(ckpt["optimizer"])
        sched.load_state_dict(ckpt["scheduler"])
        sched.base_lrs = [h["initial_lr"] for h in hyper]
        for g, h, fn in zip(opt.param_groups, hyper, sched.lr_lambdas):
            g.update(h)
            g["lr"] = h["initial_lr"] * fn(sched.last_epoch)
        sched._last_lr = [g["lr"] for g in opt.param_groups]
        return state

    def load_params(self, model: nn.Module, step: int | None = None) -> list[str]:
        """Warm start (≙ ``--load-from``, reference ``load_checkpoint(strict=False)``):
        the checkpoint's weights overlaid on ``model``; parameters and buffers
        the checkpoint lacks keep their values, its optimizer state is
        ignored. Returns the names of those kept."""
        return list(model.load_state_dict(self._load(step)["model"], strict=False).missing_keys)

    def metadata(self, step: int | None = None) -> dict | None:
        step = step if step is not None else self.latest_step()
        path = self._meta_path(step)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return None
