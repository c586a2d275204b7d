"""CFFM++-B2 finetune with prototypes, 40k iters — mirrors
``local_configs/cffm/B2/cffm.b2.480x480.vspw2_fine_w_proto.40k.py``
(lr 2e-4, head lr_mult 1.0, cluster cross-attention branch trained,
CFFM branch stop-gradiented; the centres come from ``cluster_dir``)."""

import dataclasses

from vss_cffm_tpu_torch.config import ExperimentConfig, OptimConfig, build_model_config
from vss_cffm_tpu_torch.configs.cffm_b2_vspw_160k import config as base_config


def config() -> ExperimentConfig:
    return dataclasses.replace(
        base_config(),
        model=build_model_config("b2", num_classes=124, num_clips=4, mode="finetune"),
        optim=OptimConfig(lr=2e-4, weight_decay=0.01, max_iters=40_000,
                          warmup_iters=1500, head_lr_mult=1.0),
        work_dir="work_dirs/cffm_b2_vspw_finetune_40k",
    )
