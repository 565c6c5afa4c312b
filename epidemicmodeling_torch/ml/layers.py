"""Custom learnable layers.

Counterpart of epidemicmodeling_tpu/ml/layers.py: Tools/expLayer.m:28-33
(Z = exp(alpha .* X), learnable per-channel alpha) and
Tools/MyTanhLayer.m:28-33 (Z = alpha * tanh(X / alpha), a saturating layer
with a learnable scale), used optionally in the deep LSTM stack of
testScripts/test04FullFeatureExtMLpipeline.m:476-477. Their parameters are
float32 and start from flax's initializers: alpha ~ normal(1) for
ExpLayer (drawn on the CPU from ``generator``), ones for ScaledTanhLayer;
they live on ``device``, else on the CUDA card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device


class ExpLayer(nn.Module):
    """Z = exp(alpha * X) with per-channel learnable alpha."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features = features
        self.alpha = nn.Parameter(torch.randn(
            features, generator=generator).to(resolve_device(device)))

    def forward(self, x):
        return torch.exp(self.alpha * x)


class ScaledTanhLayer(nn.Module):
    """Z = alpha * tanh(X / alpha) with per-channel learnable alpha; an
    alpha within 1e-8 of zero is taken as 1e-8."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.features = features
        self.alpha = nn.Parameter(torch.ones(features,
                                             device=resolve_device(device)))

    def forward(self, x):
        safe = torch.where(torch.abs(self.alpha) > 1e-8, self.alpha,
                           torch.full_like(self.alpha, 1e-8))
        return safe * torch.tanh(x / safe)
