"""CFFM++-B2 phase A: per-video prototype generation — mirrors
``local_configs/cffm/B2/cffm.b2.480x480.vspw2_gene_prototype.py``
(same trained model; k-means 100 centers x 10 iters over fused 1/8
features of 10 uniform frames per video of the train+val+test lists)."""

import dataclasses

from vss_cffm_tpu_torch.config import ExperimentConfig, ProtoConfig
from vss_cffm_tpu_torch.configs.cffm_b2_vspw_160k import config as base_config


def config() -> ExperimentConfig:
    return dataclasses.replace(
        base_config(),
        proto=ProtoConfig(n_clusters=100, num_frames=10, kmeans_iters=10),
        work_dir="work_dirs/cffm_b2_vspw_gene_prototype",
    )
