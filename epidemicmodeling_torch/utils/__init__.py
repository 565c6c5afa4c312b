from .device import resolve_device
from .math import clip_lo_hi, clip_hi_lo, symmetrize

__all__ = ["clip_lo_hi", "clip_hi_lo", "symmetrize", "resolve_device"]
