"""Framework-free model configuration for the PyTorch port.

Plain dataclasses mirroring the JAX package's model configs (MiT variants,
the CFFM focal decoder, the CFFM clip head and the segmentor), restricted to
the fields that clip inference and the train step read, plus the loss and
optimizer configs. Nothing here imports a framework, so the configs can be
built, compared and overridden anywhere.

``apply_overrides`` takes dotted ``key=value`` pairs like the JAX package's
CLI overrides, with one deliberate difference: a value for a tuple field must
have exactly the tuple's length (``None``/empty entries are allowed) — a short
tuple is rejected rather than silently collapsed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "MiTConfig",
    "MIT_VARIANTS",
    "CFFMDecoderConfig",
    "CFFMHeadConfig",
    "LossConfig",
    "OptimConfig",
    "TestConfig",
    "SegmentorConfig",
    "build_model_config",
    "apply_overrides",
]


DWCONV_IMPLS = (None, "fused")


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    embed_dims: tuple[int, ...] = (64, 128, 320, 512)
    depths: tuple[int, ...] = (2, 2, 2, 2)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratios: tuple[int, ...] = (4, 4, 4, 4)
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    patch_sizes: tuple[int, ...] = (7, 3, 3, 3)
    patch_strides: tuple[int, ...] = (4, 2, 2, 2)
    norm_eps: float = 1e-6
    # per-stage block form: None = composed block (its MixFFN depthwise conv
    # goes through ops.dwconv3x3); "fused" = the whole block through
    # ops.stage_block.mit_block_fused. A single string applies to all stages.
    block_impl: str | tuple | None = None
    # per-stage block form in training: None = composed block; "full" = the
    # whole block through ops.stage_block.mit_block_train; "ffn" = composed
    # attention half, then ops.mixffn.block_ffn_train for x + s·FFN(LN2 x)
    train_block_impl: str | tuple | None = None
    # inference FFN form, one string for all stages: None = composed MixFFN;
    # "fused" = x + FFN(LN2 x) through ops.mixffn.block_ffn_fused in every
    # block that block_impl does not fuse (MixFFN alone: ops.mixffn_fused)
    dwconv_impl: str | None = None

    def __post_init__(self):
        # the JAX package's other names ("fused-interpret", "xla", "shifts",
        # "shifts-cvjp", "pallas", "interpret") pick TPU or interpret forms
        if self.dwconv_impl not in DWCONV_IMPLS:
            raise ValueError(f"dwconv_impl={self.dwconv_impl!r}: expected one of {DWCONV_IMPLS}")


MIT_VARIANTS: dict[str, MiTConfig] = {
    "mit_b0": MiTConfig(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": MiTConfig(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "mit_b2": MiTConfig(depths=(3, 4, 6, 3)),
    "mit_b3": MiTConfig(depths=(3, 4, 18, 3)),
    "mit_b4": MiTConfig(depths=(3, 8, 27, 3)),
    "mit_b5": MiTConfig(depths=(3, 6, 40, 3)),
}


@dataclasses.dataclass(frozen=True)
class CFFMDecoderConfig:
    dim: int = 256
    depth: int = 2
    num_heads: int = 8
    window_size: int = 7
    expand_size: int = 3
    focal_level: int = 2
    focal_window: int = 5
    focal_l_clips: tuple[int, ...] = (1, 2, 3)
    focal_kernel_clips: tuple[int, ...] = (7, 5, 3)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    # dropout of the attention output and MLP, attention dropout, stochastic
    # depth: 0 in every CFFM config; only drop_path is ported (> 0 for the
    # other two raises)
    drop: float = 0.0
    attn_drop: float = 0.0
    drop_path: float = 0.0
    norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The reference head's ``loss_decode`` / ``sampler`` surface: CE with
    optional per-class weights and the OHEM pixel sampler, or Lovász
    (``models/losses.py:make_clip_loss``)."""

    type: str = "ce"  # 'ce' | 'lovasz'
    loss_weight: float = 1.0
    class_weight: tuple[float, ...] | None = None
    use_ohem: bool = False
    ohem_thresh: float = 0.7
    ohem_min_kept: int = 100000


@dataclasses.dataclass(frozen=True)
class CFFMHeadConfig:
    in_channels: tuple[int, ...] = (64, 128, 320, 512)
    embed_dim: int = 256
    num_classes: int = 124
    num_clips: int = 4
    dropout_ratio: float = 0.1  # Dropout2d before linear_pred and linear_pred2
    decoder: CFFMDecoderConfig = dataclasses.field(
        default_factory=lambda: CFFMDecoderConfig(dim=256, depth=2))
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """The reference recipe (``cffm.b1.480x480.vspw2.160k.py``): AdamW with
    head lr×10 and backbone-norm wd 0, poly lr with linear warmup."""

    lr: float = 6e-5
    betas: tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    max_iters: int = 160_000
    power: float = 1.0
    min_lr: float = 0.0
    warmup_iters: int = 1500
    warmup_ratio: float = 1e-6
    head_lr_mult: float = 10.0
    grad_clip: float | None = None


@dataclasses.dataclass(frozen=True)
class TestConfig:
    """Inference mode; only 'whole' is served by this port so far."""

    mode: str = "whole"
    crop_size: tuple[int, int] = (480, 480)
    stride: tuple[int, int] = (320, 320)


TRAIN_BLOCK_IMPLS = (None, "full", "ffn")


@dataclasses.dataclass(frozen=True)
class SegmentorConfig:
    backbone: str = "mit_b1"
    head: CFFMHeadConfig = dataclasses.field(default_factory=CFFMHeadConfig)
    # whole-block kernel at stages 2 and 3, composed blocks at stages 1 and 4
    block_impl: str | tuple | None = (None, "fused", "fused", None)
    # training block form, as the JAX package's default: the whole-block
    # train pair ("full") at stages 1-3, the composed block (None) at stage 4;
    # "ffn" runs the attention half composed and the FFN half as one pair
    train_block_impl: str | tuple | None = ("full", "full", "full", None)
    # inference FFN form of the blocks block_impl does not fuse (MiTConfig)
    dwconv_impl: str | None = None
    test_cfg: TestConfig = dataclasses.field(default_factory=TestConfig)

    def __post_init__(self):
        self.backbone_config  # MiTConfig checks dwconv_impl
        impls = (self.train_block_impl if isinstance(self.train_block_impl, tuple)
                 else (self.train_block_impl,))
        bad = [i for i in impls if i not in TRAIN_BLOCK_IMPLS]
        if bad:
            raise ValueError(f"train_block_impl={self.train_block_impl!r}: each stage must be "
                             f"one of {TRAIN_BLOCK_IMPLS}, got {bad[0]!r}")

    @property
    def backbone_config(self) -> MiTConfig:
        return dataclasses.replace(MIT_VARIANTS[self.backbone],
                                   block_impl=self.block_impl,
                                   train_block_impl=self.train_block_impl,
                                   dwconv_impl=self.dwconv_impl)


def build_model_config(variant: str = "b1", num_classes: int = 124,
                       num_clips: int = 4) -> SegmentorConfig:
    """CFFM-Bx: MiT-Bx backbone, CFFM head; decoder depth B0=1, B1/B2=2, B5=4."""
    depths = {"b0": 1, "b1": 2, "b2": 2, "b5": 4}[variant]
    backbone = f"mit_{variant}"
    head = CFFMHeadConfig(
        in_channels=tuple(MIT_VARIANTS[backbone].embed_dims),
        embed_dim=256,
        num_classes=num_classes,
        num_clips=num_clips,
        decoder=CFFMDecoderConfig(dim=256, depth=depths),
    )
    return SegmentorConfig(backbone=backbone, head=head)


def _coerce(value: str, current: Any) -> Any:
    if value.lower() in ("none", "null"):
        return None
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        elem = next((e for e in current if e is not None), None)
        if "," not in value and (elem is None or isinstance(elem, str)):
            return value  # a bare string on a per-stage tuple applies to all
        parts = [p.strip() for p in value.strip("()[] ").split(",")]
        if len(parts) != len(current):
            raise ValueError(
                f"override {value!r} has {len(parts)} entries; the field has "
                f"{len(current)} (write empty entries for None)")
        return tuple(None if p in ("", "None", "none") else _coerce(p, elem)
                     for p in parts)
    if current is None:
        return value
    return type(current)(value)


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``a.b.c=value`` overrides onto a (possibly nested) dataclass."""
    for ov in overrides:
        key, _, value = ov.partition("=")
        cfg = _set_path(cfg, key.strip().split("."), value.strip())
    return cfg


def _set_path(node: Any, path: list[str], value: str) -> Any:
    name = path[0]
    current = getattr(node, name)
    if len(path) == 1:
        return dataclasses.replace(node, **{name: _coerce(value, current)})
    return dataclasses.replace(node, **{name: _set_path(current, path[1:], value)})
