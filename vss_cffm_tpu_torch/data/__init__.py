from .cityscapes import CityscapesClipDataset
from .loader import TrainLoader, iterate_eval, iterate_eval_tta, prefetch_map
from .palette import VSPW_CLASSES, VSPW_PALETTE, get_palette
from .transforms import aligned_resize_clip, normalize_clip
from .vspw import VSPWVideoDataset, load_label, reduce_zero_label

__all__ = ["CityscapesClipDataset", "aligned_resize_clip", "normalize_clip", "VSPWVideoDataset",
           "load_label", "reduce_zero_label", "TrainLoader", "iterate_eval", "iterate_eval_tta", "prefetch_map",
           "VSPW_CLASSES", "VSPW_PALETTE", "get_palette"]
