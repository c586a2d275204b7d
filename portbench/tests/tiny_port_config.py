"""A tiny CFFM for the harness tests on the CPU: the program's config for
``tiny.json`` (a MiT variant registered under ``mit_portbench_tiny``)."""

from vss_cffm_tpu_torch.config import (MIT_VARIANTS, CFFMDecoderConfig, CFFMHeadConfig,
                                       DataConfig, ExperimentConfig, MiTConfig, OptimConfig,
                                       SegmentorConfig)

VARIANT = "mit_portbench_tiny"


def config() -> ExperimentConfig:
    MIT_VARIANTS.setdefault(VARIANT, MiTConfig(embed_dims=(8, 16, 24, 32), depths=(1, 1, 2, 1),
                                               num_heads=(1, 2, 3, 4)))
    head = CFFMHeadConfig(in_channels=(8, 16, 24, 32), embed_dim=16, num_classes=16, num_clips=4,
                          decoder=CFFMDecoderConfig(dim=16, depth=1, num_heads=2))
    return ExperimentConfig(model=SegmentorConfig(backbone=VARIANT, head=head),
                            optim=OptimConfig(lr=6e-5, weight_decay=0.01, max_iters=160_000,
                                              warmup_iters=1500, head_lr_mult=10.0),
                            data=DataConfig(batch_size=2, crop_size=(64, 64),
                                            img_scale=(96, 64)))
