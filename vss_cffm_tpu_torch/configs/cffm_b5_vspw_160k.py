"""CFFM-B5 @ VSPW (decoder depth 4) — mirrors ``local_configs/cffm/B5``."""

import dataclasses

from vss_cffm_tpu_torch.config import ExperimentConfig, build_model_config
from vss_cffm_tpu_torch.configs.cffm_b1_vspw_160k import config as b1_config


def config() -> ExperimentConfig:
    return dataclasses.replace(
        b1_config(),
        model=build_model_config("b5", num_classes=124, num_clips=4),
        work_dir="work_dirs/cffm_b5_vspw_160k",
    )
