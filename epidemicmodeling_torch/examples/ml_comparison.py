"""Full feature-extraction ML comparison (testScripts/test04FullFeatureExtMLpipeline.m):
extract the growth rate lambda(t) per region, build lagged-NPI + long-weekend
features, and compare ARX, ridge, linear/RBF SVR and an LSTM on
held-out-tail prediction of lambda. Prints a MAE table per model.

The long-weekend feature reads each row's calendar date (the frame's
YYYYMMDD Date). The JAX driver passes those integers through pandas'
to_datetime, which reads them as nanoseconds since 1970, so every row is
1970-01-01 there and its long-weekend column is constant.

Usage: python -m epidemicmodeling_torch.examples.ml_comparison [--device cpu]
"""

import sys

import numpy as np
import torch

from ..data import synthetic_oxford_frame
from ..ml.features import (lagged_features, long_weekend_feature,
                           standardize, train_test_split_time)
from ..ml.linear import arx_fit_predict, ridge_regression
from ..ml.lstm import LSTMForecaster, train_forecaster
from ..ml.svr import svr_fit, svr_predict
from ..rt.estimators import rt_expfit_log_lin_reg
from ..utils.device import resolve_device
from ._common import cpu_generator, split_device

MODELS = ("ridge", "arx", "svr_linear", "svr_rbf", "lstm")


def iso_dates(date_num) -> list:
    """YYYYMMDD integers as ISO date strings."""
    return [f"{d // 10000:04d}-{d // 100 % 100:02d}-{d % 100:02d}"
            for d in np.asarray(date_num, np.int64).tolist()]


def format_table(rows: dict, index_name: str = "region") -> str:
    """The MAE table as pandas' ``DataFrame.round(4).to_string()`` lays it
    out: the column names over right-aligned values, the index name on a
    line of its own."""
    width = max([len(index_name)] + [len(r) for r in rows])
    cols = [(m, max(len(m), 6)) for m in MODELS]
    head = " " * width + "".join(f"  {m:>{w}}" for m, w in cols)
    lines = [head, index_name.ljust(len(head))]
    for name, row in rows.items():
        lines.append(name.ljust(width) + "".join(
            f"  {row[m]:>{w}.4f}" for m, w in cols))
    return "\n".join(lines)


def main(*, device=None, svr_draws=None, lstm_params=None,
         svr_steps: int = 2000, lstm_epochs: int = 150):
    """Run the comparison. svr_draws: the RBF features' (omega, phase) for
    svr_fit, default drawn from a CPU generator seeded with 0 (the same
    for every region, as the JAX driver's key is); lstm_params: the LSTM's
    initial weights, default flax-distributed draws from a CPU generator
    seeded with 0 (likewise). Returns each region's MAE per model (and
    the LSTM's training losses), the models' mean MAE and the best
    model."""
    device = resolve_device(device)
    frame, _, _ = synthetic_oxford_frame(n_regions=4, n_days=220, seed=9)
    npi_cols = [c for c in frame if c[0] in "CH" and "_" in c]
    country = np.asarray(frame["CountryName"], object)
    on = dict(device=device)
    results, lstm_losses = {}, {}
    for name in sorted(set(country)):
        rows = np.flatnonzero(country == name)
        rows = rows[np.argsort(np.asarray(frame["Date"])[rows],
                               kind="stable")]
        confirmed = np.asarray(frame["ConfirmedCases"], float)[rows]
        new_cases = np.maximum(np.diff(confirmed, prepend=0.0), 0.0) + 1.0
        # growth-rate target via the log-linear regression estimator
        # (test04 uses the Rt feature stack :217-219)
        lam = rt_expfit_log_lin_reg(new_cases, wlen=14, time_unit=1.0,
                                    causal=True, **on)[2]

        U = np.column_stack([np.asarray(frame[c], float)[rows]
                             for c in npi_cols])
        dates = iso_dates(np.asarray(frame["Date"])[rows])
        feats = torch.cat([
            lagged_features(U, lags=(1, 7, 14), **on),
            long_weekend_feature(dates, **on)[:, None].to(torch.float64)],
            dim=1)
        X = standardize(feats)[0]
        (Xtr, ytr), (Xte, yte) = train_test_split_time(X, lam, 0.8)
        mae = lambda pred: float(torch.mean(torch.abs(
            torch.as_tensor(pred, device=yte.device) - yte)))

        row = {}
        w, b = ridge_regression(Xtr, ytr, lam=1e-2)
        row["ridge"] = mae(Xte @ w + b)
        _, y_arx = arx_fit_predict(lam[:len(ytr)], order=14,
                                   n_ahead=len(yte))
        row["arx"] = mae(y_arx)
        for kern in ("linear", "rbf"):
            draws = (dict(zip(("omega", "phase"), svr_draws))
                     if kern == "rbf" and svr_draws is not None else {})
            m = svr_fit(Xtr, ytr, kernel=kern, n_steps=svr_steps,
                        generator=cpu_generator(0), **draws)
            row[f"svr_{kern}"] = mae(svr_predict(m, Xte))

        model = LSTMForecaster(hidden_sizes=(16,))
        _, lstm_losses[name] = train_forecaster(
            model, Xtr[None], ytr[None, :, None],
            cpu_generator(0), num_epochs=lstm_epochs, params=lstm_params,
            **on)
        with torch.no_grad():
            pred = model(X[None])[0, :, 0][len(ytr):]
        row["lstm"] = mae(pred)
        results[name] = row

    print("MAE of held-out growth-rate prediction per model:")
    print(format_table({n: {m: round(v, 4) for m, v in r.items()}
                        for n, r in results.items()}))
    means = {m: float(np.mean([r[m] for r in results.values()]))
             for m in MODELS}
    best = min(MODELS, key=lambda m: means[m])
    print(f"best on average: {best}")
    return dict(mae=results, mean_mae=means, best=best,
                lstm_losses=lstm_losses,
                table=np.array([[results[n][m] for m in MODELS]
                                for n in results]))


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
