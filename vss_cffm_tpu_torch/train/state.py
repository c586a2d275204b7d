"""Train state: the model, its optimizer and lr schedule; the step count is
the schedule's."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..config import OptimConfig
from .optim import build_optimizer

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    @property
    def step(self) -> int:
        """Train steps taken (the schedule is stepped once per train step)."""
        return self.scheduler.last_epoch

    @classmethod
    def create(cls, model: nn.Module, cfg: OptimConfig) -> "TrainState":
        opt, sched = build_optimizer(model, cfg)
        return cls(model, opt, sched)
