"""What the XPRIZE product's requests share (run_pipeline,
prescribe_from_checkpoint, forecast_quality_assessment): input sets from a
configuration's data recipe, the program's region batches, and the check
and the control through benchmark/compare.py against
benchmark/reference/plain.py."""

from __future__ import annotations

import numpy as np
import torch

from .. import compare, data
from ..reference import plain
from . import Entry as Base

# the program's dtype (the configurations' float32; the CPU tests swap in
# float64 to hold the reference against the port)
F32 = torch.float32


def program():
    """The program's modules (imported on first use, after the harness has
    checked for a card)."""
    from epidemicmodeling_torch.data.preprocess import RegionBatch
    from epidemicmodeling_torch.pipelines import checkpoint, core
    from epidemicmodeling_torch.pipelines.config import PipelineConfig
    from epidemicmodeling_torch.pipelines.forecast_quality import \
        forecast_quality_assessment
    from epidemicmodeling_torch.pipelines.prescribe import \
        prescribe_from_checkpoint
    from epidemicmodeling_torch.pipelines.train_predict_prescribe import \
        run_pipeline
    return dict(RegionBatch=RegionBatch, checkpoint=checkpoint, core=core,
                PipelineConfig=PipelineConfig, run_pipeline=run_pipeline,
                backtest=forecast_quality_assessment,
                prescribe=prescribe_from_checkpoint)


def region_batch(pg, arrays: dict, T: int):
    """The program's RegionBatch of the first T days of an input set."""
    R = arrays["obs"].shape[0]
    cut = lambda k: arrays[k][:, :T]
    return pg["RegionBatch"](
        cut("obs"), cut("new_cases_norm"), cut("confirmed_norm"),
        cut("npis"), cut("obs_noise_var"), arrays["population"],
        np.full(R, T, np.int64), np.ones(R, bool),
        tuple(f"Synthland{r} " for r in range(R)), np.zeros((R, T)),
        np.zeros((R, T)))


class Entry(Base):
    """An XPRIZE request. ``stages``: what the request runs after training
    ("scenarios", "sweep", "mc" or "backtest"), which the control
    follows."""

    stages: tuple = ()

    def __init__(self, cfg_file, request, device, workdir):
        super().__init__(cfg_file, request, device, workdir)
        self.pg = program()
        self.recipe = cfg_file["data"]
        self.T_hist = self.recipe["t_hist"]
        self.T = self.T_hist + self.recipe["horizon"]
        self.cfg = self.pg["PipelineConfig"](**cfg_file["pipeline"])
        self.eps = data.epsilon_grid(cfg_file["epsilon_points"])
        self.inputs, self.sets = [], []

    def make_set(self, rng):
        return {"arrays": data.input_set(self.recipe, rng)}

    def add_set(self, inputs):
        self.inputs.append(inputs)
        self.sets.append(self.prepare(inputs))

    def prepare(self, inputs) -> dict:
        """The program's side of an input set."""
        raise NotImplementedError

    def release(self):
        self.sets = []

    def window(self, inputs) -> tuple:
        """(the input set's arrays over the days the request saw, the
        regression window of its training)."""
        return inputs["arrays"], self.T_hist

    def reference_kw(self, inputs) -> dict:
        """The request's own draws, as compare.compare takes them."""
        return {}

    def _reference(self, inputs):
        arrays, n_reg = self.window(inputs)
        c = plain.settings(self.cfg_file["pipeline"])
        inp = plain.inputs(arrays, data.NPI_MINS, data.NPI_MAXES,
                           data.NPI_WEIGHTS, plain.REFERENCE, self.device)
        return c, inp, n_reg

    def check(self, ans, k, log=None):
        c, inp, n_reg = self._reference(self.inputs[k])
        kw = self.reference_kw(self.inputs[k])
        return compare.compare(ans, c, inp, self.T_hist, n_reg, log=log,
                               u_random=kw.get("u_random"),
                               eps=kw.get("eps"))

    def control(self, inputs, log=None):
        c, inp, n_reg = self._reference(inputs)
        kw = self.reference_kw(inputs)
        ans = compare.control_answers(c, inp, self.T_hist, n_reg,
                                      self.stages, **kw)
        return compare.compare(ans, c, inp, self.T_hist, n_reg, log=log,
                               u_random=kw.get("u_random"),
                               eps=kw.get("eps"))


class SweepEntry(Entry):
    """A request that sweeps every epsilon and runs the Monte Carlo: its
    input sets also hold the Monte-Carlo schedules and the epsilons whose
    EKS the reference runs again."""

    def make_set(self, rng):
        s = super().make_set(rng)
        s["u_random"] = data.random_schedules(
            rng, self.cfg.num_monte_carlo, self.T - self.T_hist)
        s["eps_idx"] = data.sample_epsilons(rng, len(self.eps),
                                            self.req["sampled_epsilons"])
        return s

    def reference_kw(self, inputs):
        return dict(eps=torch.as_tensor(self.eps, dtype=torch.float64),
                    eps_idx=inputs["eps_idx"],
                    u_random=torch.as_tensor(inputs["u_random"]))

    def sweep_answers(self, par, k) -> dict:
        """Every epsilon's prescription and costs, and the sampled ones'
        indices."""
        return dict(sampled=self.inputs[k]["eps_idx"],
                    given=np.arange(len(self.eps)), u=par["u_prescribed"],
                    J0=par["J0"], J1=par["J1"])
