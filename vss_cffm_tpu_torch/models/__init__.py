"""Modules of the port: MiT backbone, CFFM decoder and head, segmentor."""

from .cffm_transformer import CFFMDecoder, build_geometry
from .heads import CFFMHead
from .mit import MiT
from .segmentor import CFFMSegmentor, set_compute_dtype, set_force

__all__ = ["MiT", "CFFMDecoder", "CFFMHead", "CFFMSegmentor", "build_geometry",
           "set_force", "set_compute_dtype"]
