"""Framework-free model configuration for the PyTorch port.

Plain dataclasses mirroring the JAX package's model configs (MiT variants,
the CFFM focal decoder, the CFFM clip head and the segmentor), restricted to
the fields that clip inference and the train step read, plus the loss and
optimizer configs, and the experiment config of the train CLI
(``ExperimentConfig``: model, optimizer, data, CFFM++ prototypes, the run's
intervals) with ``load_config``, which reads it from a Python config file
(``vss_cffm_tpu_torch/configs/``). Nothing here imports a framework, so the
configs can be built, compared and overridden anywhere.

``apply_overrides`` takes dotted ``key=value`` pairs like the JAX package's
CLI overrides, with one deliberate difference: a value for a tuple field must
have exactly the tuple's length (``None``/empty entries are allowed) — a short
tuple is rejected rather than silently collapsed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
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
    "DataConfig",
    "ProtoConfig",
    "ExperimentConfig",
    "load_config",
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
    # depth (the first two 0 in every CFFM config; each a rate in [0, 1))
    drop: float = 0.0
    attn_drop: float = 0.0
    drop_path: float = 0.0
    # recompute each block's forward in the backward (torch.utils.checkpoint)
    use_checkpoint: bool = False
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


HEAD_MODES = ("cffm", "finetune")


@dataclasses.dataclass(frozen=True)
class CFFMHeadConfig:
    in_channels: tuple[int, ...] = (64, 128, 320, 512)
    embed_dim: int = 256
    num_classes: int = 124
    num_clips: int = 4
    dropout_ratio: float = 0.1  # Dropout2d before linear_pred, linear_pred2, linear_pred3
    decoder: CFFMDecoderConfig = dataclasses.field(
        default_factory=lambda: CFFMDecoderConfig(dim=256, depth=2))
    # 'cffm' | 'finetune': CFFM++ finetune adds the cluster cross-attention
    # branch (decoder_swin, linear_pred3) and trains only it
    mode: str = "cffm"
    cluster_blend: float = 0.5  # eval output x2 + cluster_blend · x3 in finetune mode
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)

    def __post_init__(self):
        if self.mode not in HEAD_MODES:
            raise ValueError(f"CFFMHeadConfig.mode={self.mode!r}: expected one of {HEAD_MODES}")


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
    """Inference mode (the reference's ``test_cfg``): 'whole', or 'slide'
    with ``crop_size`` / ``stride`` windows whose probabilities are averaged
    (``eval/evaluator.py:ClipEvaluator``)."""

    mode: str = "whole"
    crop_size: tuple[int, int] = (480, 480)
    stride: tuple[int, int] = (320, 320)


TRAIN_BLOCK_IMPLS = (None, "full", "ffn")
ARCHS = ("cffm", "image")


@dataclasses.dataclass(frozen=True)
class SegmentorConfig:
    backbone: str = "mit_b1"
    head: CFFMHeadConfig = dataclasses.field(default_factory=CFFMHeadConfig)
    # "cffm": the clip segmentor (MiT + CFFM head); "image": the single-frame
    # SegFormer (MiT + SegFormer head), which reads only the head's decode
    # fields (in_channels, embed_dim, num_classes, dropout_ratio)
    arch: str = "cffm"
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
        if self.arch not in ARCHS:
            raise ValueError(f"SegmentorConfig.arch={self.arch!r}: expected one of {ARCHS}")
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


def build_model_config(variant: str = "b1", num_classes: int = 124, num_clips: int = 4,
                       mode: str = "cffm") -> SegmentorConfig:
    """CFFM-Bx: MiT-Bx backbone, CFFM head; decoder depth B0=1, B1/B2=2, B5=4;
    ``mode="finetune"`` is CFFM++'s head with the cluster branch."""
    depths = {"b0": 1, "b1": 2, "b2": 2, "b5": 4}[variant]
    backbone = f"mit_{variant}"
    head = CFFMHeadConfig(
        in_channels=tuple(MIT_VARIANTS[backbone].embed_dims),
        embed_dim=256,
        num_classes=num_classes,
        num_clips=num_clips,
        decoder=CFFMDecoderConfig(dim=256, depth=depths),
        mode=mode,
    )
    return SegmentorConfig(backbone=backbone, head=head)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/vspw/VSPW_480p"
    crop_size: tuple[int, int] = (480, 480)
    img_scale: tuple[int, int] = (853, 480)
    dilation: tuple[int, ...] = (-9, -6, -3)
    batch_size: int = 8  # global (2 clips/GPU × 4 GPUs in the reference)
    num_workers: int = 4
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ProtoConfig:
    """CFFM++ phase-A prototype generation (the ``_gene_prototype`` configs,
    reference ``cffm.bX...vspw2_gene_prototype.py``): k-means over fused 1/8
    features of ``num_frames`` uniformly sampled frames per video."""

    n_clusters: int = 100
    num_frames: int = 10
    kmeans_iters: int = 10


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: SegmentorConfig = dataclasses.field(default_factory=lambda: build_model_config("b1"))
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    proto: ProtoConfig = dataclasses.field(default_factory=ProtoConfig)
    work_dir: str = "work_dirs/default"
    log_interval: int = 50
    checkpoint_interval: int = 4000
    load_from: str | None = None
    resume_from: str | None = None
    cluster_dir: str = "./cluster_centers"
    seed: int = 0
    bf16: bool = True


def load_config(path: str) -> ExperimentConfig:
    """The ``ExperimentConfig`` that the Python file at ``path`` returns from
    its ``config()``. The file's directory is on ``sys.path`` while it loads,
    so that a user's config can import a sibling file by its bare name (the
    configs in ``vss_cffm_tpu_torch/configs`` import their base by the
    package path instead)."""
    cfg_dir = os.path.dirname(os.path.abspath(path))
    added = cfg_dir not in sys.path
    if added:
        sys.path.insert(0, cfg_dir)
    try:
        spec = importlib.util.spec_from_file_location("user_config", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["user_config"] = mod
        spec.loader.exec_module(mod)
        cfg = mod.config()
    finally:
        if added:
            sys.path.remove(cfg_dir)
    if not isinstance(cfg, ExperimentConfig):
        raise TypeError(f"{path}: config() returned {type(cfg).__name__}, expected the port's "
                        "ExperimentConfig")
    return cfg


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
