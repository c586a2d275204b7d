"""Demos of the port: ``python -m vss_cffm_tpu_torch.demo.image_demo`` and
``python -m vss_cffm_tpu_torch.demo.video_demo``."""
