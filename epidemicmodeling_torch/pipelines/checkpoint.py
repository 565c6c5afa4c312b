"""Trained parameters carried across packages.

The parameter side of epidemicmodeling_tpu/pipelines/checkpoint.py: turn the
JAX package's TrainedRegionParams / RegionInit (or any mapping of their
fields, e.g. taken through ``np.asarray`` or loaded from an .npz) into the
port's, so one stage of each package can run on the other's inputs. The
npz/.mat checkpoint files are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import numpy as np

from .core import RegionInit, TrainedRegionParams, to_tensor


def _fields(d) -> dict:
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def trained_params_from_numpy(d, dtype=None,
                              device=None) -> TrainedRegionParams:
    """d: names, population, a1, b1, a2, b2 (a TrainedRegionParams of
    either package, or a mapping of arrays). dtype None keeps float64."""
    d = _fields(d)
    t = lambda k: to_tensor(d[k], dtype, device)
    return TrainedRegionParams(
        names=tuple(str(n) for n in d["names"]),
        population=np.asarray(d["population"], float),
        a1=t("a1"), b1=t("b1"), a2=t("a2"), b2=t("b2"))


def region_init_from_numpy(d, dtype=None, device=None) -> RegionInit:
    """d: I0, s_init, Ps_init, Q, s_noise_std, i_noise_std (a RegionInit of
    either package, or a mapping of arrays). dtype None keeps float64."""
    d = _fields(d)
    return RegionInit(*(to_tensor(d[k], dtype, device)
                        for k in RegionInit._fields))
