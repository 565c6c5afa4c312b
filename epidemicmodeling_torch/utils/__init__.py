from .math import clip_lo_hi, clip_hi_lo

__all__ = ["clip_lo_hi", "clip_hi_lo"]
