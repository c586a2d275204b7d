"""Modules of the port: MiT backbone, CFFM decoder, the CFFM and SegFormer
heads, CFFM++'s cluster head, the clip and image segmentors."""

from .cffm_transformer import CFFMDecoder, build_geometry
from .cluster_head import ClusterDecoder
from .heads import CFFMHead, SegFormerHead
from .mit import MiT
from .segmentor import (CFFMSegmentor, ImageSegmentor, build_segmentor, set_compute_dtype,
                        set_force)

__all__ = ["MiT", "CFFMDecoder", "CFFMHead", "SegFormerHead", "ClusterDecoder", "CFFMSegmentor",
           "ImageSegmentor", "build_segmentor", "build_geometry", "set_force",
           "set_compute_dtype"]
