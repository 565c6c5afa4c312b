"""What the example drivers share: the ``--device`` option and the inputs
several of them build from the synthetic regions."""

from __future__ import annotations

import numpy as np
import torch

from ..data import build_region_batch, preprocess_region


def split_device(argv):
    """Take ``--device NAME`` (or ``--device=NAME``) out of a driver's
    argument list: returns (NAME or None, the other arguments)."""
    argv = list(argv)
    device, rest, i = None, [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value (cpu, cuda, ...)")
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return device, rest


def truth_batches(truth: dict, t_hist=None, horizon: int = 0):
    """RegionBatches of a synthetic frame's generating truth, as the
    example drivers build them: each region's noise-free new cases
    (s * i * alpha * pop) summed into confirmed cases over the first
    ``t_hist`` days (all when None), through preprocess_region. Returns
    (names, batch over the history, the same with ``horizon`` NaN days
    appended, or None when horizon is 0)."""
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:t_hist], None,
                                      tr["u"][:t_hist], tr["pop"]))
        names.append(name)
    bt = build_region_batch(sers, names)
    bf = build_region_batch(sers, names, horizon=horizon) if horizon else None
    return names, bt, bf


def cpu_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``: the drivers draw on the CPU and
    move the draws, so a run on the card and one on the CPU draw alike."""
    return torch.Generator().manual_seed(seed)

