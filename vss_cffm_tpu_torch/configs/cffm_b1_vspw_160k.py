"""CFFM-B1 @ VSPW, 160k iters — mirrors
``local_configs/cffm/B1/cffm.b1.480x480.vspw2.160k.py``."""

from vss_cffm_tpu_torch.config import DataConfig, ExperimentConfig, OptimConfig, build_model_config


def config() -> ExperimentConfig:
    return ExperimentConfig(
        model=build_model_config("b1", num_classes=124, num_clips=4),
        optim=OptimConfig(lr=6e-5, weight_decay=0.01, max_iters=160_000,
                          warmup_iters=1500, head_lr_mult=10.0),
        data=DataConfig(batch_size=8),
        work_dir="work_dirs/cffm_b1_vspw_160k",
    )
