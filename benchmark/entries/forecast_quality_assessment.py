"""One request: forecast_quality_assessment (the look-ahead backtest)."""

from __future__ import annotations

import torch

from .. import data
from . import _xprize


class Entry(_xprize.Entry):
    """forecast_quality_assessment over the training window: training on its
    head, then every (region, start) filter with the last ``starts`` days
    masked one by one, error curves up to ``look_ahead`` days."""

    stages = ("backtest",)

    def prepare(self, inputs):
        return dict(bt=_xprize.region_batch(self.pg, inputs["arrays"],
                                            self.T_hist))

    def request(self, k):
        S, H = self.req["starts"], self.req["look_ahead"]
        out = self.pg["backtest"](
            self.sets[k]["bt"], data.NPI_MINS, data.NPI_MAXES,
            self.T_hist - S, S, H, self.cfg, dtype=_xprize.F32,
            device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def answers(self, out, k):
        return {"trained": {n: getattr(out.trained, n)
                            for n in ("a1", "b1", "a2", "b2")},
                "backtest_shape": (self.req["starts"],
                                   self.req["look_ahead"]),
                "backtest": dict(err_plus=out.est_error_plus,
                                 err_smooth=out.est_error_smooth,
                                 mean_smooth=out.mean_error_smooth,
                                 median_smooth=out.median_error_smooth)}

    def window(self, inputs):
        cut = {n: (v if n == "population" else v[:, :self.T_hist])
               for n, v in inputs["arrays"].items()}
        return cut, self.T_hist - self.req["starts"]

    def reference_kw(self, inputs):
        return dict(backtest_shape=(self.req["starts"],
                                    self.req["look_ahead"]))

    def filter_calls(self):
        R, S = self.recipe["regions"], self.req["starts"]
        return [("ekf3", self.T_hist - S, R)] * 2 \
            + [("ekf3", self.T_hist, R * S)]
