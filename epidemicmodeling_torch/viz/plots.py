"""Publication-style figures mirroring the reference's visual QC.

The port's own copy of epidemicmodeling_tpu/viz/plots.py (the same figures,
line for line):

- per-state estimate curves with sigma envelopes
  (Tools/TrainPredictPrescribeNPI.m:534-583)
- new-case scenario comparison on a log axis (:635-694)
- the Pareto cloud: blue random / black fixed / red optimal front
  (:848-866, README.md:22-24)
- backtest error-vs-horizon curves (Tools/ForecastQualityAssessment.m:423-429)
- the per-region 4-panel training diagnostic: new-case fits, rho monitor,
  alpha-vs-regression-fit, NPI schedule (:697-733)
- NPI-schedule overlays: history + prescribed future per NPI dimension
  (:733, testScripts/testPrescribeXPRIZE01.m:258-259)

All functions take tensors (copied to the host) or arrays, draw on a
created matplotlib Axes, and return the figure: headless-safe (Agg).
matplotlib is imported on the first plot, not with the module.
"""

from __future__ import annotations

import numpy as np

from ..utils.math import host_array


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _host(a, dtype=None):
    """A tensor (on any device) or array-like as a NumPy array."""
    return np.asarray(host_array(a), dtype)


def select_optimal_index(J0, J1):
    """The reference's showcased tradeoff point: the epsilon index minimizing
    (J0/max(J0))^2 + (J1/max(J1))^2 (TrainPredictPrescribeNPI.m:633).
    J0, J1: (E,). Returns int index."""
    J0 = _host(J0, float)
    J1 = _host(J1, float)
    n0 = np.max(J0) if np.max(J0) > 0 else 1.0
    n1 = np.max(J1) if np.max(J1) > 0 else 1.0
    return int(np.argmin((J0 / n0) ** 2 + (J1 / n1) ** 2))


def plot_state_estimates(s_minus=None, s_plus=None, s_smooth=None,
                         P_minus=None, P_plus=None, P_smooth=None,
                         state_names=("s", "i", r"$\alpha$"), title=None,
                         path=None):
    """Per-state errorbar-style curves (estimate +- sqrt(P_ii) envelope).
    Arrays: (T, m) states and optional (T, m, m) covariances."""
    plt = _plt()
    ref = next(a for a in (s_smooth, s_plus, s_minus) if a is not None)
    m = _host(ref).shape[1]
    fig, axes = plt.subplots(m, 1, figsize=(9, 2.4 * m), sharex=True)
    axes = np.atleast_1d(axes)
    series = [("minus", s_minus, P_minus), ("plus", s_plus, P_plus),
              ("smooth", s_smooth, P_smooth)]
    for k in range(m):
        ax = axes[k]
        for label, S, P in series:
            if S is None:
                continue
            S = _host(S)
            ax.plot(S[:, k], label=label, lw=1.2)
            if P is not None:
                P = _host(P)
                sd = np.sqrt(np.maximum(P[:, k, k], 0.0))
                ax.fill_between(np.arange(S.shape[0]), S[:, k] - sd,
                                S[:, k] + sd, alpha=0.2)
        ax.set_ylabel(state_names[k] if k < len(state_names) else f"x{k}")
        ax.grid(True, alpha=0.3)
    axes[0].legend(loc="best", fontsize=8)
    if title:
        axes[0].set_title(title)
    axes[-1].set_xlabel("days")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_scenarios(cases_by_scenario: dict, population: float = 1.0,
                   ground_truth=None, title=None, path=None):
    """New-case curves for the NPI scenarios on a log axis
    (the reference's headline figure, :635-660).
    cases_by_scenario: {label: (T,) normalized new-case series}."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 5))
    if ground_truth is not None:
        ax.plot(_host(ground_truth), "k", lw=2.5, label="Ground truth")
    for label, series in cases_by_scenario.items():
        ax.plot(population * _host(series), lw=1.6, label=label)
    ax.set_yscale("log")
    ax.set_ylim(bottom=1)
    ax.set_xlabel("days")
    ax.set_ylabel("daily new cases")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_pareto_cloud(J0_random, J1_random, J0_opt, J1_opt, front_mask=None,
                      J0_fixed=None, J1_fixed=None, population: float = 1.0,
                      title=None, path=None):
    """The Pareto figure: blue random cloud, red optimal front, black 'x'
    fixed-NPI point (TrainPredictPrescribeNPI.m:848-866)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(population * _host(J0_random), _host(J1_random), "bo",
            ms=4, alpha=0.5, label="random NPI")
    J0_opt = _host(J0_opt)
    J1_opt = _host(J1_opt)
    if front_mask is not None:
        fm = _host(front_mask, bool)
        ax.plot(population * J0_opt[fm], J1_opt[fm], "ro", ms=5,
                label="optimal (Pareto front)")
    else:
        ax.plot(population * J0_opt, J1_opt, "ro", ms=5, label="optimal")
    if J0_fixed is not None:
        ax.plot(population * _host(J0_fixed), _host(J1_fixed),
                "kx", ms=14, mew=3, label="fixed NPI")
    ax.set_xlabel("Human factor")
    ax.set_ylabel("NPI cost")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_box_aspect(1)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_training_diagnostic(obs_new_cases, s_smooth_round1, s_smooth_round2,
                             rho_round1, rho_round2, npi_schedule,
                             a1=None, b1=None, a2=None, b2=None,
                             npi_maxes=None, num_regression_days=None,
                             population: float = 1.0, title=None, path=None):
    """The per-region 4-panel training QC figure a modeler debugs with
    (Tools/TrainPredictPrescribeNPI.m:697-733):

    1. observed new cases vs the round-1 (no-input) and round-2
       (with-NPI-input) smoothed model fits N*s*i*alpha (:697-706)
    2. the rho innovation-consistency monitor, round 1 vs round 2 (:708-713)
    3. the estimated alpha series (both rounds) overlaid with the
       regression fits b + (u_max - u) @ a — the reference's
       y_data_train / y_pred_lasso panel (:715-722)
    4. the historic NPI schedule, `plot(InterventionPlans)` (:724-726)

    obs_new_cases: (T,) normalized new cases; s_smooth_round*: (T, 3);
    rho_round*: (T,); npi_schedule: (T, P). a/b round coefficients and
    npi_maxes enable the regression-fit overlay; num_regression_days
    marks the training window with a dashed vline.
    """
    plt = _plt()
    fig, axes = plt.subplots(4, 1, figsize=(9, 10), sharex=True)
    obs = _host(obs_new_cases, float)
    T = obs.shape[0]

    ax = axes[0]
    ax.plot(population * obs, "k", lw=2, label="NewCases")
    for label, S in (("SMOOTH", s_smooth_round1),
                     ("SMOOTH2", s_smooth_round2)):
        S = _host(S)
        ax.plot(population * S[:, 0] * S[:, 1] * S[:, 2], lw=1.2,
                label=label)
    ax.set_ylabel("new cases")
    ax.legend(loc="best", fontsize=8)
    ax.grid(True, alpha=0.3)
    if title:
        ax.set_title(title)

    ax = axes[1]
    ax.plot(_host(rho_round1, float), label="rho round 1 (no input)")
    ax.plot(_host(rho_round2, float), "r",
            label="rho round 2 (with input)")
    ax.set_ylabel(r"$\rho$")
    ax.legend(loc="best", fontsize=8)
    ax.grid(True, alpha=0.3)

    ax = axes[2]
    u = _host(npi_schedule, float)
    for label, S in ((r"$\alpha$ round 1", s_smooth_round1),
                     (r"$\alpha$ round 2", s_smooth_round2)):
        ax.plot(_host(S)[:, 2], lw=1.2, label=label)
    if a1 is not None and npi_maxes is not None:
        x = _host(npi_maxes, float)[None, :] - u   # (T, P)
        for label, a, b in (("fit round 1", a1, b1), ("fit round 2", a2, b2)):
            if a is None:
                continue
            ax.plot(_host(b, float) + x @ _host(a, float),
                    "--", lw=1.2, label=label)
    ax.set_ylabel(r"$\alpha$ vs regression fit")
    ax.legend(loc="best", fontsize=8)
    ax.grid(True, alpha=0.3)

    ax = axes[3]
    ax.plot(u, lw=1.0)
    ax.set_ylabel("NPI level")
    ax.set_xlabel("days")
    ax.grid(True, alpha=0.3)

    if num_regression_days is not None:
        for ax in axes:
            ax.axvline(T - int(num_regression_days), color="k", ls="--",
                       lw=1, alpha=0.6)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_npi_schedule(u_hist, u_prescribed=None, npi_maxes=None,
                      npi_names=None, title=None, path=None):
    """Per-NPI schedule overlay: the historic schedule as solid steps and
    the prescribed future continuation as dashed steps, one subplot per NPI
    dimension with the codebook maximum as the y-limit
    (Tools/TrainPredictPrescribeNPI.m:733 `plot(InterventionPlans)`;
    testScripts/testPrescribeXPRIZE01.m:258-259 `plot(opt_control_input')`).

    u_hist: (T_hist, P); u_prescribed: optional (H, P) appended after
    T_hist; npi_maxes: optional (P,) codebook maxima for y-limits.
    """
    plt = _plt()
    u = _host(u_hist, float)
    T_hist, P = u.shape
    names = (list(npi_names) if npi_names is not None
             else [f"NPI {k}" for k in range(P)])
    fig, axes = plt.subplots(P, 1, figsize=(9, 1.1 * P), sharex=True)
    axes = np.atleast_1d(axes)
    for k in range(P):
        ax = axes[k]
        ax.step(np.arange(T_hist), u[:, k], where="post", lw=1.2,
                color="C0")
        if u_prescribed is not None:
            up = _host(u_prescribed, float)
            ax.step(np.arange(T_hist - 1, T_hist + up.shape[0]),
                    np.concatenate([u[-1:, k], up[:, k]]), where="post",
                    lw=1.2, ls="--", color="C3")
            ax.axvline(T_hist - 1, color="k", ls=":", lw=0.8, alpha=0.6)
        if npi_maxes is not None:
            ax.set_ylim(-0.2, float(_host(npi_maxes)[k]) + 0.2)
        ax.set_ylabel(names[k], rotation=0, ha="right", va="center",
                      fontsize=7)
        ax.grid(True, alpha=0.3)
        ax.tick_params(labelsize=7)
    axes[-1].set_xlabel("days")
    if title:
        axes[0].set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_backtest_curves(est_error, title=None, path=None):
    """Error-vs-horizon curves: per-start-day grey traces + mean/median
    overlays (ForecastQualityAssessment.m:423-429). est_error: (S, H)."""
    plt = _plt()
    E = _host(est_error)
    H = E.shape[1]
    fig, ax = plt.subplots(figsize=(9, 5))
    hx = np.arange(1, H + 1)
    ax.plot(hx, E.T, color="0.6", lw=0.5, alpha=0.6)
    ax.plot(hx, np.mean(E, axis=0), "b", lw=3, label="mean")
    ax.plot(hx, np.median(E, axis=0), "k", lw=3, label="median")
    ax.set_xlabel("look-ahead horizon (days)")
    ax.set_ylabel("% error")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
