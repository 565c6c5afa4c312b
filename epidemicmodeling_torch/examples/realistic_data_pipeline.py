"""Full pipeline on jointly-pathological "real-artifact" data.

Every reference driver consumes the real OxCGRT download, whose case
histories carry negative revisions, reporting gaps, weekend dips, NaN
holes and late-starting regions in combination
(Tools/TrainPredictPrescribeNPI.m:121-170 is the cleaning layer built for
them). This driver writes a realistic_oxford_frame to CSV, runs the full
CSV -> loader -> cleaning -> train-predict-prescribe path on the "lanes"
backend (on the card: the ekf3 and ekf6 kernels), and reports how well
training recovered the generating epidemic despite the corruption.

Usage: python -m epidemicmodeling_torch.examples.realistic_data_pipeline [--device cpu]
"""

import datetime
import sys
import tempfile

import numpy as np

from ..control import epsilon_grid
from ..data import NPI_MAXES_DEFAULT, realistic_oxford_frame, \
    write_oxford_csvs
from ..pipelines import PipelineConfig, train_predict_prescribe
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import cpu_generator, split_device


def _artefact_counts(frame: dict):
    """The share of NaN case days, the days whose cumulative count falls
    (over each region's non-NaN days) and the NaN NPI cells."""
    cases = np.asarray(frame["ConfirmedCases"], float)
    country = np.asarray(frame["CountryName"], object)
    neg_days = 0
    for name in dict.fromkeys(country):
        c = cases[country == name]
        neg_days += int((np.diff(c[~np.isnan(c)]) < 0).sum())
    npi_cols = [c for c in frame if c[0] in "CH" and "_" in c]
    nan_npis = int(sum(np.isnan(np.asarray(frame[c], float)).sum()
                       for c in npi_cols))
    return float(np.isnan(cases).mean()), neg_days, nan_npis


def main(n_regions: int = 4, n_days: int = 200, n_eps: int = 6,
         seed: int = 7, *, device=None, dtype=None, generator=None,
         u_random=None):
    """Run the driver; the Monte-Carlo schedules come from ``u_random``
    (N, H, P) when given, else from ``generator`` (default: a CPU
    generator seeded with 0). Returns the artefact counts, each region's
    recovered share of the clean total and front size, and the
    pipeline's result."""
    device = resolve_device(device)
    frame, pops, truth = realistic_oxford_frame(n_regions=n_regions,
                                                n_days=n_days, seed=seed)
    nan_frac, neg_days, nan_npis = _artefact_counts(frame)
    with tempfile.TemporaryDirectory() as tmp:
        files = write_oxford_csvs(tmp, frame, pops)
        print(f"raw data: {nan_frac:.1%} NaN case days, "
              f"{neg_days} negative-revision days, {nan_npis} NaN NPI cells")

        # train on the first ~85% of the generated window, predict the rest
        # (dates derived from the generator's own start/n_days so the split
        # matches the data regardless of n_days)
        d0 = datetime.date(2020, 3, 1)
        d_train = (d0 + datetime.timedelta(days=int(n_days * 0.85))
                   ).isoformat()
        d_end = (d0 + datetime.timedelta(days=n_days - 1)).isoformat()
        res = train_predict_prescribe(
            npi_weights=np.ones(12),
            epsilon_values=epsilon_grid(n_eps).numpy(),
            start_train_date=d0.isoformat(), end_train_date=d_train,
            start_regression_date=d0.isoformat(),
            end_predict_date=d_end,
            data_file=files["data"], geo_file=files["geos"],
            populations_file=files["populations"],
            npi_maxes=NPI_MAXES_DEFAULT,
            cfg=PipelineConfig(backend="lanes", smoother_gain="solve",
                               pareto_chunk=max(2, n_eps // 2),
                               num_monte_carlo=16),
            generator=generator or cpu_generator(0), u_random=u_random,
            dtype=dtype, device=device)

    print("\nregion            total-cases recovered  front size")
    front_sizes = host_array(res.pareto_front).sum(axis=0)
    bt = res.batch_train
    nc = np.asarray(bt.new_cases_norm)
    recovered = []
    for r, name in enumerate(res.trained.names):
        clean = truth[name]["confirmed_clean"]
        pop = truth[name]["pop"]
        got = nc[r].sum() * pop
        want = clean[min(nc.shape[1], len(clean)) - 1]
        recovered.append(got / want)
        print(f"  {name.strip():14s} {got / want:8.1%} of clean truth"
              f"      {int(front_sizes[r])}/{n_eps}")
    J0 = host_array(res.pareto["J0"])
    if not np.isfinite(J0).all():
        raise RuntimeError("a prescription's cost is not finite")
    print("\npipeline completed on pathological data; all costs finite")
    return dict(nan_frac=nan_frac, neg_days=neg_days, nan_npis=nan_npis,
                recovered=np.array(recovered), front_sizes=front_sizes,
                result=res)


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
