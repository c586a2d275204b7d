"""Experiment configs of the port: each file defines ``config() ->
ExperimentConfig`` (``vss_cffm_tpu_torch.config.load_config``) and names the
reference config it mirrors. A config builds on another by importing it by
its package path and replacing fields."""
