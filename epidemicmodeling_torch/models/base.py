"""EKF system-equation plug-in interface of the generic EKF/EKS core.

Counterpart of epidemicmodeling_tpu/models/base.py:25: the struct of eight
function handles of Tools/GenericExtendedKalmanFilter.m:9-34 as a frozen
dataclass of functions.

The JAX package writes every callback for one filter and batches with vmap.
Here a callback takes and returns tensors with any number of leading batch
dimensions ``...`` (lanes, and the time steps when the core evaluates many
steps at once), and the matrix algebra broadcasts over them:
    s : (..., m)  state            u : (..., p) input (NaN requests in-model
    x : (..., n)  observation                       optimal control)
    A : (..., m, m) state Jacobian  B : (..., m, l) process-noise Jacobian
    C : (..., n, m) obs Jacobian    D : (..., n, q) obs-noise Jacobian
``params`` leaves are per-filter scalars of the batch shape (or 0-dim) and
per-filter vectors of shape (..., p). A returned matrix that is the same for
every filter (an identity B or D) may drop the batch dimensions.
``k`` is the step index: an int, or an integer tensor that broadcasts with
the batch dimensions when many steps are evaluated at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class EKFSystem:
    """Pluggable system equations for the generic EKF/EKS.
    ``state_hessian_terms``/``obs_hessian_terms`` are only consulted when the
    filter runs with order != 1 (the second-order EKF of
    Tools/Rt_ExpFitEKF.m)."""

    state_dim: int
    obs_dim: int
    input_dim: int

    # (u, s, w_bar, params, k) -> (u_opt, s_next)
    nlin_state_update: Callable[..., Any]
    # (u, s, w_bar, params, k) -> (A, B)
    state_jacobians: Callable[..., Any]
    # (u, s, v_bar, params, k) -> x
    nlin_obs_update: Callable[..., Any]
    # (u, s, v_bar, params, k) -> (C, D)
    obs_jacobian: Callable[..., Any]
    # (s, params, k) -> s
    state_hard_margins: Callable[..., Any]
    # (x, params, k) -> x
    obs_hard_margins: Callable[..., Any]
    # (u, s, P, w_bar, Q, params, k) -> (fs, Fsp, fw, Fwp)   [order 2 only]
    state_hessian_terms: Optional[Callable[..., Any]] = None
    # (u, s, P, v_bar, R, params, k) -> (gs, Gsp, gv, Gvp)   [order 2 only]
    obs_hessian_terms: Optional[Callable[..., Any]] = None


def stack_matrix(rows) -> torch.Tensor:
    """A (..., r, c) tensor from r rows of c entries, each a tensor or a
    Python number; the tensors broadcast together (one stack launch)."""
    flat = [e for row in rows for e in row]
    ref = next(e for e in flat if isinstance(e, torch.Tensor))
    flat = torch.broadcast_tensors(*(
        e if isinstance(e, torch.Tensor)
        else torch.full((), e, dtype=ref.dtype, device=ref.device)
        for e in flat))
    return torch.stack(flat, dim=-1).unflatten(-1, (len(rows), len(rows[0])))
