"""Random weights of a configuration, made on the device from the seed.

One normal draw for all parameters, cut into the tensors of
``reference.param_shapes`` and scaled per kind, in f32 (the recipe keeps its
parameters in f32). The scales follow the architecture's initialisers
(trunc-normal 0.02 dense kernels, fan-out normal convolutions, 0.01 class
convolutions, mean pooling) with small random biases, norm affines and
position-bias tables, so that a path that drops a bias or a norm's affine
shows in the outputs.
"""

from __future__ import annotations

import math

import torch

from .reference.cffm import param_shapes


def _scale(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """(mean, std) of the parameter ``name``."""
    if name.endswith("num_batches_tracked"):
        return 0.0, 0.0
    if name.endswith("running_var"):
        return 1.0, 0.0
    if ".pool_layers" in name and name.endswith(".weight"):
        return 1.0 / shape[-1], 0.02 / shape[-1]
    if "relative_position_bias_table" in name or name.endswith((".bias", "running_mean")):
        return 0.0, 0.02
    if "norm" in name or ".bn." in name:  # norm weights
        return 1.0, 0.02
    if len(shape) == 2:
        return 0.0, 0.02
    if name.endswith(("linear_pred.weight", "linear_pred2.weight")):
        return 0.0, 0.01
    if name.endswith("linear_fuse.conv.weight"):
        return 0.0, math.sqrt(1.0 / shape[0])
    groups = shape[0] if shape[1] == 1 else 1
    fan_out = shape[2] * shape[3] * shape[0] // groups
    return 0.0, math.sqrt(2.0 / fan_out)


def make_params(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """{name: tensor} on ``device``: f32 parameters and BN buffers, int64
    ``num_batches_tracked``; the same seed gives the same weights."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((total,), generator=g, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = _scale(name, shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            out[name] = flat[at:at + n].view(shape) * std + mean
        at += n
    return out
