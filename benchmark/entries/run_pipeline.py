"""One request: run_pipeline (train, scenarios, sweep, Monte Carlo, front)."""

from __future__ import annotations

import torch

from .. import data
from . import _xprize


class Entry(_xprize.SweepEntry):
    """run_pipeline: train, scenarios, the Pareto sweep, the Monte-Carlo
    baseline and the front, from numpy region batches (what the CLI hands
    it)."""

    stages = ("scenarios", "sweep", "mc")

    def prepare(self, inputs):
        arrays = inputs["arrays"]
        return dict(bt=_xprize.region_batch(self.pg, arrays, self.T_hist),
                    bf=_xprize.region_batch(self.pg, arrays, self.T))

    def request(self, k):
        s, inputs = self.sets[k], self.inputs[k]
        out = self.pg["run_pipeline"](
            s["bt"], s["bf"], inputs["arrays"]["actual"], self.T_hist,
            data.NPI_WEIGHTS, self.eps, data.NPI_MINS, data.NPI_MAXES,
            self.T_hist, self.cfg, dtype=_xprize.F32, device=self.device,
            u_random=inputs["u_random"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def stage_seconds(self, out):
        return dict(out.stage_seconds)

    def answers(self, out, k):
        sweep = self.sweep_answers(out.pareto, k)
        sweep["front"] = out.pareto_front
        return {
            "trained": {n: getattr(out.trained, n)
                        for n in ("a1", "b1", "a2", "b2")},
            "s_hist": out.s_hist,
            "scenarios": {n: (sc.J0, sc.J1)
                          for n, sc in out.scenarios.items()},
            "sweep": sweep,
            "mc": (out.monte_carlo["J0"], out.monte_carlo["J1"]),
        }

    def filter_calls(self):
        R = self.recipe["regions"]
        return [("ekf3", self.T_hist, R)] * 2 + [("ekf3", self.T, R)] * 2 \
            + [("ekf6", self.T, len(self.eps) * R)]
