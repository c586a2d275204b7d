"""CFFM-B2 @ VSPW — mirrors ``local_configs/cffm/B2``."""

import dataclasses

from vss_cffm_tpu_torch.config import ExperimentConfig, build_model_config
from vss_cffm_tpu_torch.configs.cffm_b1_vspw_160k import config as b1_config


def config() -> ExperimentConfig:
    return dataclasses.replace(
        b1_config(),
        model=build_model_config("b2", num_classes=124, num_clips=4),
        work_dir="work_dirs/cffm_b2_vspw_160k",
    )
