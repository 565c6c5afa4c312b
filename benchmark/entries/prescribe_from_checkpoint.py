"""One request: prescribe_from_checkpoint (the sweep and the Monte Carlo from
saved trained parameters)."""

from __future__ import annotations

import os

import torch

from .. import data
from . import _xprize, run_pipeline


class Entry(run_pipeline.Entry):
    """prescribe_from_checkpoint: the full epsilon sweep and the Monte-Carlo
    baseline from trained parameters saved with the program's
    save_trained_params and loaded back with load_trained_params, and the
    historic states of its forecast_scenarios, made once an input set in
    set-up."""

    stages = ("sweep", "mc")

    def prepare(self, inputs):
        s = super().prepare(inputs)
        core, ck = self.pg["core"], self.pg["checkpoint"]
        out = core.train_regions(s["bt"], data.NPI_MINS, data.NPI_MAXES,
                                 self.T_hist, self.cfg, dtype=_xprize.F32,
                                 device=self.device)
        path = os.path.join(self.workdir, f"trained_{len(self.sets)}.npz")
        ck.save_trained_params(path, out.trained)
        trained = ck.load_trained_params(path)
        _, s_hist = core.forecast_scenarios(
            s["bf"], trained, out.init, data.NPI_WEIGHTS, data.NPI_MINS,
            data.NPI_MAXES, self.T_hist, self.cfg, dtype=_xprize.F32,
            device=self.device)
        s.update(trained=trained, init=out.init, s_hist=s_hist)
        return s

    def request(self, k):
        s = self.sets[k]
        par, mc = self.pg["prescribe"](
            s["trained"], s["bf"], s["s_hist"], s["init"], self.eps,
            data.NPI_WEIGHTS, data.NPI_MINS, data.NPI_MAXES, self.T_hist,
            self.cfg, dtype=_xprize.F32, device=self.device,
            u_random=self.inputs[k]["u_random"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return par, mc

    def stage_seconds(self, out):
        return None

    def answers(self, out, k):
        par, mc = out
        s = self.sets[k]
        return {
            "trained": {n: getattr(s["trained"], n)
                        for n in ("a1", "b1", "a2", "b2")},
            "s_hist": s["s_hist"],
            "sweep": self.sweep_answers(par, k),
            "mc": (mc["J0"], mc["J1"]),
        }

    def filter_calls(self):
        R = self.recipe["regions"]
        return [("ekf6", self.T, len(self.eps) * R)]
