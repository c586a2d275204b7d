"""vss_cffm_tpu_torch — the PyTorch / CUDA port of vss_cffm_tpu.

CFFM clip inference (MiT backbone, per-frame MLP decode, CFFM focal decoder)
and the CFFM train step (``train/``: clip CE loss, paramwise AdamW) in
PyTorch, with the JAX package's TPU kernels rewritten by hand in CUDA for
Hopper (``csrc/``, built with nvcc at first use). The JAX package
``vss_cffm_tpu`` stays the reference; this package imports nothing of it.
"""

import importlib

# the package's names, each imported from its module at first use, so that
# importing one subpackage (``vss_cffm_tpu_torch.ops``, all that a process
# reloading an exported program needs) does not import the model code
_NAMES = {"SegmentorBundle": "apis", "init_segmentor": "apis", "inference_segmentor": "apis",
          "SegmentorConfig": "config", "build_model_config": "config",
          "CFFMSegmentor": "models"}

__all__ = list(_NAMES)


def __getattr__(name: str):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
