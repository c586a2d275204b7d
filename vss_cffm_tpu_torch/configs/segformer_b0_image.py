"""Single-frame SegFormer-B0 @ VSPW — the image model zoo surface, the
per-frame half of CFFM (reference ``segformer_head.py`` and the image
``EncoderDecoder``); mirrors ``configs/segformer_b0_image.py``."""

import dataclasses

from vss_cffm_tpu_torch.config import DataConfig, ExperimentConfig, build_model_config


def config() -> ExperimentConfig:
    return ExperimentConfig(
        model=dataclasses.replace(build_model_config("b0", num_classes=124, num_clips=1),
                                  arch="image"),
        data=DataConfig(dilation=(), batch_size=16),
        work_dir="work_dirs/segformer_b0_image",
    )
