"""Controlled SI-alpha model step (Tools/SIalpha_Controlled.m:24-28).

Counterpart of epidemicmodeling_tpu/models/si_alpha.py:46. The state is
(s, i, alpha); alpha relaxes towards b + a'(u_max - u) with rate gamma.
"""

from __future__ import annotations

import torch

from ..utils.math import clip_lo_hi


def si_alpha_step_fields(s, i, al, u_t, n_s, n_i, n_al, params):
    """One Euler step on unpacked state fields. The fields and noise draws
    are (...,) batches; u_t and params["a"] / ["u_max"] are (..., p).
    Returns (s1, i1, alpha1)."""
    dt = params["dt"]
    s1 = clip_lo_hi(
        s - dt * (al * s * i + n_s * params["s_noise_std"]), 0.0, 1.0)
    i1 = clip_lo_hi(
        i + dt * (al * s * i - params["beta"] * i
                  + n_i * params["i_noise_std"]), 0.0, 1.0)
    drive = (-params["gamma"] * al + params["gamma"] * params["b"]
             + params["gamma"] * torch.sum(
                 params["a"] * (params["u_max"] - u_t), dim=-1)
             + n_al * params["alpha_noise_std"])
    a1 = clip_lo_hi(al + dt * drive, params["alpha_min"], params["alpha_max"])
    return s1, i1, a1
