"""NaN-ordered clips shared by the model equations.

MATLAB's min/max ignore NaN operands, so the reference's clips sanitize a NaN
state to a bound instead of propagating it (CLAUDE.md "Parity conventions").
torch.fmin/fmax have exactly that semantics; torch.clamp propagates NaN and
must not replace these. Counterpart of epidemicmodeling_tpu/utils/math.py:25-41.
"""

from __future__ import annotations

import torch


def _like(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def clip_lo_hi(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """MATLAB ``max(lo, min(hi, x))``: a NaN x maps to hi."""
    return torch.fmax(_like(lo, x), torch.fmin(_like(hi, x), x))


def clip_hi_lo(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """MATLAB ``min(hi, max(lo, x))``: a NaN x maps to lo."""
    return torch.fmin(_like(hi, x), torch.fmax(_like(lo, x), x))
