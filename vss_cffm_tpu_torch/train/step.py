"""The train step: forward, clip loss, backward, AdamW update.

Port of ``vss_cffm_tpu/train/step.py``. Parameters stay f32; the modules
compute in their ``compute_dtype`` (bf16 on the card) with f32 softmax,
loss and BatchNorm statistics. Randomness (Dropout2d, stochastic depth)
comes from the ``torch.Generator`` handed to each step.

Over N ranks (``parallel``), each holding its rows of the global batch, the
step computes what one process computes on the global batch: the fuse BN
and OHEM reduce over the ranks inside the forward (Lovász gathers the
batch), every random mask is the global draw's rows, and after the backward
one all-reduce averages the gradients (the mean of the ranks' mean losses
is the global mean, as each rank holds as many pixels), before the norm,
the clip and AdamW; the returned loss and accuracy are the global means.

On a (data, frames) clip mesh (``mesh=``, ``parallel.create_clip_mesh``)
each rank holds its frames of its rows' clips and the whole clips' labels
(``parallel.shard_clip_batch``); the forward gathers the fused features
over the frames group (``CFFMSegmentor.forward``), so every rank of a
frames group computes the loss of its rows' whole clips, and OHEM reduces
over the data group. The same world mean of the gradients is then still
the one-process gradient; see ``step``.

A parameter that the loss does not reach (in CFFM++ finetune mode all but
the head's cluster branch) gets a zero gradient, as ``jax.grad`` gives it:
AdamW then moves it by its weight decay alone, as optax's
``add_decayed_weights`` does in the JAX step. (The reference's mmseg detaches
these branches and leaves their gradients ``None``, which AdamW skips.)
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from .. import parallel
from ..config import LossConfig
from ..data.transforms import normalize_clip
from ..models.losses import make_clip_loss
from .optim import global_norm

__all__ = ["make_train_step", "device_normalize"]


def device_normalize(imgs_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR → RGB (x − mean) / std on the images' device, in f32, stored
    in ``dtype``."""
    return normalize_clip(imgs_u8).to(dtype)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    loss_cfg: LossConfig | None = None, ignore_index: int = 255,
                    mesh: parallel.ClipMesh | None = None) -> Callable:
    """Returns ``step(batch, generator) -> metrics``.

    ``batch`` = {"imgs": (B, T, H, W, 3) uint8 BGR or normalised float,
    "labels": (B, T, H, W) uint8/int, and in CFFM++ finetune mode
    "cluster_centers": the videos' (B, n, C) centres or a ``(centers, mask)``
    pair}; ``metrics`` = {"loss_seg", "acc_seg",
    "grad_norm"} as 0-d tensors (the norm of the gradients before the
    optimizer's global-norm clip, ``OptimConfig.grad_clip``). The loss is
    built from ``loss_cfg``, by default the head's ``LossConfig``
    (``model.config.head.loss``), as the JAX step does. The model must be in
    ``train()`` mode; the loss takes the model's ``force``. ``mesh``: the
    batch is this rank's share on that clip mesh (``shard_clip_batch``)."""
    if model.config.arch != "cffm":
        raise ValueError(f"make_train_step trains clip models only; this model has "
                         f"arch={model.config.arch!r} (the JAX step cannot train an image "
                         "model either)")
    if loss_cfg is None:
        loss_cfg = model.config.head.loss
    loss_of = make_clip_loss(loss_cfg, ignore_index)
    group = mesh.data_group if mesh is not None else None
    params = [p for p in model.parameters() if p.requires_grad]
    zeros: dict[int, torch.Tensor] = {}  # the zero gradients of the unreached ones, kept

    def step(batch: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
        imgs = batch["imgs"]
        if imgs.dtype == torch.uint8:
            imgs = device_normalize(imgs, model.backbone.compute_dtype)
        optimizer.zero_grad(set_to_none=True)
        logits = model(imgs, train=True, generator=generator,
                       cluster_centers=batch.get("cluster_centers"), mesh=mesh)
        losses = loss_of(logits, batch["labels"], force=model.force, group=group)
        losses["loss_seg"].backward()
        grads = [p.grad for p in params if p.grad is not None]
        # The mean over the whole world. Let L = (1/D)·Σ_d L_d, L_d the loss of
        # data index d's rows, and F the frames a clip is split into. Each of
        # the F ranks of a frames group backpropagates all of L_d, so the head
        # gets F copies of ∂L_d/∂θ; the frames' gather sums the F upstream
        # gradients into each rank's slice, so the backbone and decode get F·
        # their share of ∂L_d/∂θ. Every gradient is F·D times its share of
        # ∂L/∂θ, and the sum over the D·F ranks divided by D·F is ∂L/∂θ (the
        # BN's sums are world sums of the same F·D·L). Without a frames split
        # F = 1: data parallelism. The rank tests hold it against one process.
        parallel.all_reduce_mean_(grads)
        norm = global_norm(grads)
        for i, p in enumerate(params):
            if p.grad is None:  # kept across steps: AdamW reads it, the clip scales 0
                if i not in zeros:
                    zeros[i] = torch.zeros_like(p)
                p.grad = zeros[i]
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        if parallel.is_distributed():  # global means: every rank holds as many pixels
            (means,) = parallel.all_reduce_mean_([torch.stack(list(metrics.values()))])
            metrics = dict(zip(metrics, means))
        metrics["grad_norm"] = norm
        return metrics

    return step
