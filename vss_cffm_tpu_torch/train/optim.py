"""Optimizer and learning-rate schedule with mmcv paramwise semantics.

Port of ``vss_cffm_tpu/train/optim.py`` over ``torch.optim.AdamW``
(reference recipe ``cffm.b1.480x480.vspw2.160k.py``):

- AdamW, lr 6e-5, betas (0.9, 0.999), eps 1e-8, weight decay 0.01, decay
  proportional to each group's lr (as optax's ``add_decayed_weights`` before
  the lr scaling);
- ``paramwise_cfg.custom_keys`` by mmcv's first-match rule over the sorted
  keys ``[pos_block, head, norm]`` on the reference parameter names: a name
  containing ``head`` gets lr × ``head_lr_mult`` and keeps its decay (the
  head's norms included), a name containing ``norm`` elsewhere gets decay 0;
  biases are decayed;
- poly lr ``(lr − min_lr)·(1 − t/max_iters)^power + min_lr`` scaled during
  the warmup by ``1 − (1 − warmup_ratio)·(1 − t/warmup_iters)``, as a
  ``LambdaLR`` stepped once per train step (step t uses the schedule at t);
- ``grad_clip``: the gradients clipped in place to that global norm by a
  step pre-hook of the optimizer, before Adam sees them (optax's
  ``clip_by_global_norm`` at the head of the chain).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from ..config import OptimConfig

__all__ = ["OptimConfig", "poly_schedule", "paramwise_multipliers", "build_optimizer",
           "global_norm", "clip_by_global_norm_"]


def poly_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Step → learning rate (mmcv poly with linear warmup)."""

    def schedule(step: int) -> float:
        frac = 1.0 - step / cfg.max_iters
        poly = (cfg.lr - cfg.min_lr) * max(frac, 0.0) ** cfg.power + cfg.min_lr
        if cfg.warmup_iters <= 0:
            return poly
        warm = min(step / cfg.warmup_iters, 1.0)
        return poly * (1.0 - (1.0 - cfg.warmup_ratio) * (1.0 - warm))

    return schedule


def paramwise_multipliers(name: str, head_lr_mult: float) -> tuple[float, bool]:
    """(lr multiplier, decayed) of the parameter called ``name``."""
    if "pos_block" in name:
        return 1.0, False
    if "head" in name:
        return head_lr_mult, True
    if "norm" in name:
        return 1.0, False
    return 1.0, True


def global_norm(tensors) -> torch.Tensor:
    """f32 L2 norm of all the tensors together (optax ``global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """In place, optax ``clip_by_global_norm``: g · max_norm / max(norm,
    max_norm), given the grads' global ``norm``."""
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)


def build_optimizer(model: nn.Module, cfg: OptimConfig
                    ) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW with one parameter group per (lr multiplier, decayed) class,
    clipping to ``cfg.grad_clip`` when set, and its poly-with-warmup
    ``LambdaLR``."""
    groups: dict[tuple[float, bool], list] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups.setdefault(paramwise_multipliers(name, cfg.head_lr_mult), []).append(p)
    param_groups = [{"params": ps, "lr": cfg.lr * mult,
                     "weight_decay": cfg.weight_decay if decayed else 0.0}
                    for (mult, decayed), ps in groups.items()]
    opt = torch.optim.AdamW(param_groups, lr=cfg.lr, betas=cfg.betas, eps=1e-8,
                            weight_decay=cfg.weight_decay)
    if cfg.grad_clip is not None:
        def clip(optimizer, args, kwargs):
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            if grads:
                clip_by_global_norm_(grads, cfg.grad_clip, global_norm(grads))

        opt.register_step_pre_hook(clip)
    schedule = poly_schedule(cfg)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: schedule(t) / cfg.lr)
    return opt, sched
