"""Where the port's entry points run: on the CUDA card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    device of ``like`` when it is a tensor, else the CUDA card. Raises when
    that is a CUDA device and no card is present: nothing carries on on the
    CPU unless the caller asks for it (``device="cpu"``)."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device='cpu' to run on the CPU")
    return device
