"""The optimizer of the ML stack: optax's adam and clip_by_global_norm,
written out in optax's operation order.

The JAX package trains with optax (ml/lstm.py: clip_by_global_norm(1) then
adam(piecewise_constant_schedule(lr, {125: 0.2})); ml/svr.py: adam(lr)).
torch.optim.Adam and clip_grad_norm_ differ from it in rounding and in
what they compute (clip_grad_norm_ adds 1e-6 to the norm and scales even
below the threshold's edge), so the port keeps optax's update:

    mu = (1 - b1) g + b1 mu ;  nu = (1 - b2) g^2 + b2 nu
    u  = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
    p  = p + (-lr_n) u

with the bias corrections 1 - b^n formed in double precision and rounded
to the parameter's dtype, as optax does under x64.
"""

from __future__ import annotations

import torch


class AdamState:
    """Adam's moments (one per parameter) and its update count."""

    def __init__(self, params):
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One optax adam step on ``params`` in place, with learning rate
    ``lr`` for this step."""
    state.count += 1
    for k, (p, g) in enumerate(zip(params, grads)):
        mu = (1 - b1) * g + b1 * state.mu[k]
        nu = (1 - b2) * (g * g) + b2 * state.nu[k]
        state.mu[k], state.nu[k] = mu, nu
        bc1 = torch.tensor(1 - b1 ** state.count, dtype=p.dtype,
                           device=p.device)
        bc2 = torch.tensor(1 - b2 ** state.count, dtype=p.dtype,
                           device=p.device)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p.copy_(p + (-lr) * u)


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: every gradient scaled by
    max_norm / ||g|| when the global norm ||g|| is not below max_norm
    (computed on the device, no host sync)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]

