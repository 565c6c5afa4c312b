"""One request: run_pipeline in the configuration's own dtype (``dtype`` in
the configuration file; float64 for the deployment the MATLAB reference
computes, where the run_pipeline entry runs float32)."""

from __future__ import annotations

import torch

from .. import data
from . import run_pipeline


class Entry(run_pipeline.Entry):
    """run_pipeline as the run_pipeline entry calls it, in the dtype the
    configuration names."""

    def __init__(self, cfg_file, request, device, workdir):
        super().__init__(cfg_file, request, device, workdir)
        self.dtype = getattr(torch, cfg_file["dtype"])

    def request(self, k):
        s, inputs = self.sets[k], self.inputs[k]
        out = self.pg["run_pipeline"](
            s["bt"], s["bf"], inputs["arrays"]["actual"], self.T_hist,
            data.NPI_WEIGHTS, self.eps, data.NPI_MINS, data.NPI_MAXES,
            self.T_hist, self.cfg, dtype=self.dtype, device=self.device,
            u_random=inputs["u_random"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def reference_kw(self, inputs):
        # the Monte-Carlo schedules on the device the reference runs on:
        # compare.control_answers rolls them out as they come
        kw = super().reference_kw(inputs)
        kw["u_random"] = kw["u_random"].to(self.device)
        return kw
