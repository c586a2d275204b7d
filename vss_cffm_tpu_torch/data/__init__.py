from .transforms import aligned_resize_clip, normalize_clip

__all__ = ["aligned_resize_clip", "normalize_clip"]
