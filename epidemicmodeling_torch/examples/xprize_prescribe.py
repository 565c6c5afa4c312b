"""XPRIZE train-predict-prescribe driver.

The framework's counterpart of testScripts/testPrescribeXPRIZE02.m: configure
dates, the 12 Oxford NPIs with their codebook maxima, the 250-point epsilon
grid and equal NPI weights, then run the full pipeline on the "lanes"
backend (on the card: the ekf3 and ekf6 kernels) and write the
prescription CSV and the trained parameters into the working directory.

Usage:
    python -m epidemicmodeling_torch.examples.xprize_prescribe <OxCGRT.csv> <geos.csv> <pops.csv>
    python -m epidemicmodeling_torch.examples.xprize_prescribe --synthetic
Add ``--device cpu`` to run on the CPU.
"""

import sys
import tempfile

import numpy as np

from ..control import epsilon_grid
from ..data import (NPI_MAXES_DEFAULT, synthetic_oxford_frame,
                    write_oxford_csvs)
from ..data.xprize_io import write_prescriptions_csv
from ..pipelines import PipelineConfig, train_predict_prescribe
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import cpu_generator, split_device

# the XPRIZE Phase-II configuration (testPrescribeXPRIZE02.m:12-15)
PHASE2_DATES = ("2020-03-15", "2021-05-29", "2021-08-29")
SYNTHETIC_DATES = ("2020-03-01", "2020-09-16", "2020-10-26")


def main(argv, *, device=None, dtype=None, generator=None, u_random=None):
    """Run the driver on ``argv`` (``[prog, "--synthetic"]`` or ``[prog,
    data, geos, pops]``). The Monte-Carlo schedules come from ``u_random``
    (N, H, P) when given, else from ``generator`` (default: a CPU
    generator seeded with 0). Returns the front sizes per region, the
    region count, the prescriptions file and the pipeline's result."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        if len(argv) >= 2 and argv[1] == "--synthetic":
            frame, pops, _ = synthetic_oxford_frame(n_regions=6, n_days=240,
                                                    seed=0)
            files = write_oxford_csvs(tmp, frame, pops)
            data_file, geo_file, pop_file = (
                files["data"], files["geos"], files["populations"])
            start_train, end_train, end_predict = SYNTHETIC_DATES
        else:
            data_file, geo_file, pop_file = argv[1:4]
            start_train, end_train, end_predict = PHASE2_DATES

        P = 12
        npi_weights = np.ones(P) * P / P          # equal weights (:56-57)
        eps = epsilon_grid(250).numpy()           # log+linear grid (:49-53)
        res = train_predict_prescribe(
            npi_weights=npi_weights, epsilon_values=eps,
            start_train_date=start_train, end_train_date=end_train,
            start_regression_date=start_train, end_predict_date=end_predict,
            data_file=data_file, geo_file=geo_file,
            populations_file=pop_file, npi_mins=np.zeros(P),
            npi_maxes=NPI_MAXES_DEFAULT,
            trained_params_file="trained_params",
            cfg=PipelineConfig(backend="lanes", smoother_gain="solve"),
            generator=generator or cpu_generator(0), u_random=u_random,
            dtype=dtype, device=device)

    # export the Pareto-front prescriptions for each region's best tradeoff
    # points (up to 10 indices, XPRIZE schema)
    u = host_array(res.pareto["u_prescribed"])        # (E, R, H, P)
    front = host_array(res.pareto_front)               # (E, R)
    idxs = np.linspace(0, u.shape[0] - 1, 10).astype(int)
    out = write_prescriptions_csv("prescriptions.csv", res.trained.names,
                                  end_train, u[idxs])
    print(f"wrote {out}; front sizes: {front.sum(axis=0)}")
    print(f"trained params saved to trained_params.npz "
          f"({len(res.trained.names)} regions)")
    return dict(front_sizes=front.sum(axis=0),
                n_regions=len(res.trained.names), prescriptions=out,
                result=res)


if __name__ == "__main__":
    dev, args = split_device(sys.argv)
    main(args if len(args) > 1 else [args[0], "--synthetic"], device=dev)
