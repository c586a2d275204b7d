"""vss_cffm_tpu_torch — the PyTorch / CUDA port of vss_cffm_tpu.

CFFM clip inference (MiT backbone, per-frame MLP decode, CFFM focal decoder)
in PyTorch, with the JAX package's TPU kernels rewritten by hand in CUDA for
Hopper (``csrc/``, built with nvcc at first use). The JAX package
``vss_cffm_tpu`` stays the reference; this package imports nothing of it.
"""

from .apis import SegmentorBundle, inference_segmentor, init_segmentor
from .config import SegmentorConfig, build_model_config
from .models import CFFMSegmentor

__all__ = ["SegmentorBundle", "init_segmentor", "inference_segmentor",
           "SegmentorConfig", "build_model_config", "CFFMSegmentor"]
