"""The comparison that decides ``correct``: a request's answers against the
plain reference (benchmark/reference/plain.py), one number per stage.

Answers are a plain dict that an entry fills from the program's outputs
(or, for the control, the reference's own pipeline in lower precision):
``trained`` (a1, b1, a2, b2), ``s_hist``, ``scenarios`` ({name: (J0, J1)}),
``sweep`` (``given``: the epsilon indices whose prescriptions ``u`` and
costs ``J0``, ``J1`` it holds, every one for the program; ``sampled``: the
indices whose EKS the reference runs again; where the request makes one,
``front``: the front over every epsilon), ``mc`` ((J0, J1)),
``backtest_shape`` and ``backtest`` (err_plus, err_smooth, mean, median).

Two chains of the reference. One follows the program's state, stage by
stage: it takes the program's round-2 coefficients (and, for the sweep and
the Monte Carlo, its historic states), so that each stage is held on its
own inputs. The other is the reference's own, from the data: its own
training, historic states, forecasts, sweep and Monte Carlo; the
``*_own_gap`` numbers hold the program's answers against it, and so hold
the training, which no answer shows by itself, and every stage after it.
The training's own numbers (``train_numbers``) are logged and not
compared: the float32 control reads on them as the program does
(PERF.md).

Each number is a gap, 0 when the answers equal the reference's:

- ``s_hist_gap``: the historic smoothed states against the reference's
  EKS run with the program's round-2 coefficients: per region and state,
  the largest difference over the largest reference value.
- ``scenario_gap``: the four scenarios' J0 and J1, the largest relative
  difference, the reference rolling out from its historic states of the
  program's coefficients; ``scenario_own_gap``: the same against the
  reference's own chain.
- ``checkpoint_gap`` (where the request makes no scenarios, as a
  prescription from a checkpoint): what the program's trained parameters
  and historic states say, their four scenarios rolled out by the
  reference, against the reference's own chain; the largest relative
  difference of J0 and J1.
- ``sweep_flip_share``: the share of prescribed cells (epsilon, region,
  day, NPI) of the sampled epsilons whose level differs from the
  reference's, which runs the 6-state EKS from the program's coefficients
  and rolls out from the program's historic states.
- ``sweep_cost_gap``: the median over the sampled lanes of the relative
  difference of J0 and of J1, the larger; ``sweep_own_cost_gap``: the
  same against the reference's own chain (its training, historic states
  and EKS).
- ``sweep_score_gap``: every epsilon's prescription scored again (rolled
  out from the program's historic state, its costs over the window)
  against the J0 and J1 the program reports for it: the largest relative
  difference. It holds every lane of every chunk, where the flip share
  holds the EKS on the sampled epsilons.
- ``mc_gap``: the Monte-Carlo costs, the largest relative difference, the
  reference rolling out from the program's state; ``mc_own_gap``: the
  same from the reference's own chain.
- ``front_mismatch``: the cells whose front membership differs from the
  reference's front of the program's own J0 and J1 over every epsilon
  (exact).
- ``backtest_gap``: every error curve against the reference's backtest
  from the program's coefficients, |a - b| / (1 + |b|) in percent points,
  infinite where exactly one of the two is not finite, the largest over
  every region, start and day; ``backtest_own_gap``: against the
  reference's backtest from its own training, each region's largest, the
  median over the regions. The float32 NNLS stops at float32's tolerance
  (10 eps |X|_1 n), so in a share of the regions its coefficients differ
  from float64's, and their 60-day forecasts with them; the control, in
  float32 too, lands on the same coefficients, so only the typical region
  separates the two (PERF.md).
- ``regression_excess`` (logged with the training, not compared: the
  control reads as the program does, PERF.md): see ``train_numbers``.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import plain


def _d(x, like):
    return torch.as_tensor(x).to(dtype=like.dtype, device=like.device)


def rel_max(a, b) -> float:
    a = _d(a, b)
    return float((torch.abs(a - b) / torch.abs(b)).max())


def rel_by_region(a, b):
    """Per region (the last dim) the largest |a - b| / |b|."""
    a = _d(a, b)
    return (torch.abs(a - b) / torch.abs(b)).reshape(-1, b.shape[-1]).amax(0)


def scaled_rows(a, b) -> float:
    """Largest |a - b| of each row (dim 0) and state (dim -1) over the
    largest |b| there."""
    a = _d(a, b)
    num = torch.amax(torch.abs(a - b), dim=1)
    den = torch.amax(torch.abs(b), dim=1)
    return float((num / den).max())


def curve_gaps(a, b):
    """Per region (dim 0) the largest |a - b| / (1 + |b|), infinite where
    exactly one of the two is not finite."""
    a = _d(a, b)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    d = torch.where(fb, torch.abs(a - b) / (1.0 + torch.abs(b)),
                    torch.zeros_like(b))
    d = torch.where(fa != fb, torch.full_like(d, float("inf")), d)
    return d.reshape(d.shape[0], -1).amax(1)


def train_numbers(ans, ref: plain.Trained, inp, n_regression, c,
                  ar: plain.Arith) -> dict:
    """``inp``: the training window the regressions saw.
    ``train_fit_gap``: what each round's regression says against the
    reference's own (logged). ``regression_excess``: each round's
    regression problem as the reference poses it (round 2 from the
    program's round-1 coefficients), what the program's coefficients leave
    unexplained beyond what the reference's own solution of that problem
    leaves, over the target's variance: the largest of a region and a
    round. A float32 NNLS that lands on another active set of a nearly
    degenerate problem explains about as much; a coefficient set that is
    wrong does not."""
    tr = ans["trained"]
    T_train = inp.obs.shape[1]
    fit, excess = [], []
    for k in ("1", "2"):
        a_p, b_p = _d(tr["a" + k], inp.obs), _d(tr["b" + k], inp.obs)
        fit_p = plain.fitted_alpha(inp, a_p, b_p, n_regression, T_train)
        fit_r = plain.fitted_alpha(inp, getattr(ref, "a" + k),
                                   getattr(ref, "b" + k), n_regression,
                                   T_train)
        fit.append(float((torch.amax(torch.abs(fit_p - fit_r), 1)
                          / torch.amax(torch.abs(fit_r), 1)).max()))
        prev = {} if k == "1" else dict(a1=_d(tr["a1"], inp.obs),
                                        b1=_d(tr["b1"], inp.obs))
        x, y = plain.regression_problem(ar, c, inp, n_regression, **prev)
        a_r, b_r = plain.nnls_with_intercept(ar, x, y,
                                             c["nonneg_iterations"])
        sse = lambda a, b: torch.sum(
            (y - b[:, None] - torch.sum(x * a[:, None, :], -1)) ** 2, -1)
        var = torch.sum((y - y.mean(-1, keepdim=True)) ** 2, -1)
        excess.append(float(((sse(a_p, b_p) - sse(a_r, b_r)) / var).max()))
    return {"train_fit_gap": max(fit), "regression_excess": max(excess)}


def compare(ans: dict, c: dict, inp_full: plain.Inputs, T_hist: int,
            n_regression: int, u_random=None, eps=None,
            ar: plain.Arith = plain.REFERENCE, log=None) -> dict:
    """The numbers of every stage that ``ans`` holds. ``inp_full``: the
    input set over the whole window in the reference's dtype; ``eps``: the
    full epsilon grid (float64 tensor) when a sweep is compared;
    ``u_random``: the Monte-Carlo schedules; ``log``: a callable that
    receives informational lines (the training fits, the sweep's u_max
    shares and largest costate)."""
    out = {}
    t = lambda x: _d(x, inp_full.obs)
    tr = ans["trained"]
    a2, b2 = t(tr["a2"]), t(tr["b2"])
    if "backtest" in ans:
        S, H = ans["backtest_shape"]
        head = plain.head(inp_full, inp_full.obs.shape[1] - S)
    else:
        head = plain.head(inp_full, T_hist)
    own = plain.train(ar, c, head, n_regression)
    if log is not None:
        log(f"training: {train_numbers(ans, own, head, n_regression, c, ar)}")
    if "backtest" in ans:
        got = ans["backtest"]
        gaps = {}
        for name, (a, b) in (("backtest_gap", (a2, b2)),
                             ("backtest_own_gap", (own.a2, own.b2))):
            ref = plain.backtest(ar, c, inp_full, a, b, S, H)
            gaps[name] = torch.stack([curve_gaps(got[f], getattr(ref, f))
                                      for f in plain.Backtest._fields]
                                     ).amax(0)
        out["backtest_gap"] = float(gaps["backtest_gap"].max())
        own_gap = gaps["backtest_own_gap"]
        out["backtest_own_gap"] = float(torch.median(own_gap))
        if log is not None:
            q = torch.quantile(own_gap, torch.tensor(
                [0.9, 1.0], dtype=own_gap.dtype, device=own_gap.device))
            log(f"backtest_own_gap over the regions: 90th percentile "
                f"{float(q[0])!r}, largest {float(q[1])!r}")
        return out
    s_hist_p = t(ans["s_hist"])
    s_hist_r = plain.historic_states(ar, c, inp_full, a2, b2, T_hist)
    out["s_hist_gap"] = scaled_rows(s_hist_p, s_hist_r)
    s_hist_own = plain.historic_states(ar, c, inp_full, own.a2, own.b2,
                                       T_hist)
    if "scenarios" in ans:
        gaps = {}
        for name, (a, b, sh) in (("scenario_gap", (a2, b2, s_hist_r)),
                                 ("scenario_own_gap",
                                  (own.a2, own.b2, s_hist_own))):
            ref_sc = plain.scenarios(ar, c, inp_full, a, b, sh, T_hist)
            gaps[name] = torch.stack([
                rel_by_region(ans["scenarios"][n][k], ref_sc[n][k])
                for n in ref_sc for k in (0, 1)]).amax(0)
        out["scenario_gap"] = float(gaps["scenario_gap"].max())
        out["scenario_own_gap"] = float(gaps["scenario_own_gap"].max())
    else:
        # what the program's trained parameters and historic states say:
        # their scenario forecasts against the reference's own
        got = plain.scenarios(ar, c, inp_full, a2, b2, s_hist_p, T_hist)
        ref_sc = plain.scenarios(ar, c, inp_full, own.a2, own.b2, s_hist_own,
                                 T_hist)
        out["checkpoint_gap"] = float(torch.stack([
            rel_by_region(got[n][k], ref_sc[n][k])
            for n in ref_sc for k in (0, 1)]).max())
    if "sweep" in ans:
        sw = ans["sweep"]
        idx = np.asarray(sw["sampled"])
        pos = torch.as_tensor(np.searchsorted(np.asarray(sw["given"]), idx))
        u_p = t(sw["u"][pos.to(sw["u"].device)])
        J0_p = t(sw["J0"])[pos.to(inp_full.obs.device)]
        J1_p = t(sw["J1"])[pos.to(inp_full.obs.device)]
        e = t(eps[idx])
        ref_sw = plain.sweep(ar, c, inp_full, a2, b2, s_hist_p, e, T_hist)
        out["sweep_flip_share"] = float((u_p != ref_sw.u).double().mean())
        med = lambda a, b: float(torch.median(torch.abs(a / b - 1)))
        out["sweep_cost_gap"] = max(med(J0_p, ref_sw.J0),
                                    med(J1_p, ref_sw.J1))
        own_sw = plain.sweep(ar, c, inp_full, own.a2, own.b2, s_hist_own, e,
                             T_hist)
        out["sweep_own_cost_gap"] = max(med(J0_p, own_sw.J0),
                                        med(J1_p, own_sw.J1))
        out["sweep_score_gap"] = score_gap(sw, ar, c, inp_full, a2, b2,
                                           s_hist_p, T_hist)
        if "front" in sw:
            out["front_mismatch"] = float(
                (plain.front(t(sw["J0"]), t(sw["J1"]))
                 != t(sw["front"]).bool()).sum())
        if log is not None:
            hi = inp_full.u_max
            share = lambda u: float((u == hi).double().mean())
            log(f"sweep: u_max share of the prescribed cells at eps="
                f"{float(eps[idx[0]]):.3g}: {share(u_p[0]):.4f} (reference "
                f"{share(ref_sw.u[0]):.4f}), at eps={float(eps[idx[-1]]):.3g}:"
                f" {share(u_p[-1]):.4f} (reference {share(ref_sw.u[-1]):.4f});"
                f" sampled epsilons {len(idx)}; the reference's smoothed "
                f"costates: largest finite |value| {ref_sw.costate_max:.4e}, "
                f"share not finite {ref_sw.costate_nonfinite:.3e}")
    if "mc" in ans:
        for name, (a, b, sh) in (("mc_gap", (a2, b2, s_hist_p)),
                                 ("mc_own_gap", (own.a2, own.b2,
                                                 s_hist_own))):
            J0, J1 = plain.monte_carlo(ar, c, inp_full, a, b, sh,
                                       t(u_random), T_hist)
            out[name] = max(rel_max(ans["mc"][0], J0),
                            rel_max(ans["mc"][1], J1))
    return out


def score_gap(sw, ar, c, inp_full, a2, b2, s_hist, T_hist: int,
              chunk: int = 125) -> float:
    """The largest relative difference between the J0 and J1 reported for
    each given epsilon and its prescription scored again by the reference,
    ``chunk`` epsilons at a time."""
    gap = 0.0
    for lo in range(0, sw["u"].shape[0], chunk):
        u = _d(sw["u"][lo:lo + chunk], inp_full.obs)
        J0, J1 = plain.score(ar, c, inp_full, a2, b2, s_hist, u, T_hist)
        gap = max(gap, rel_max(sw["J0"][lo:lo + chunk], J0),
                  rel_max(sw["J1"][lo:lo + chunk], J1))
    return gap


def control_answers(c: dict, inp_full: plain.Inputs, T_hist: int,
                    n_regression: int, stages: tuple, ar=plain.CONTROL,
                    eps=None, eps_idx=None, u_random=None,
                    backtest_shape=None) -> dict:
    """The answers of the reference computed in ``ar`` (the control: float32
    with its products in TF32) in the program's place: its own training,
    then each stage from its own state, as the program's answers are
    made. ``stages``: the stages the cell's request runs ("scenarios",
    "sweep", "mc" or "backtest")."""
    inp = inp_full._replace(**{f: getattr(inp_full, f).to(ar.dtype)
                               for f in plain.Inputs._fields})
    if "backtest" in stages:
        S, H = backtest_shape
        tr = plain.train(ar, c, plain.head(inp, inp.obs.shape[1] - S),
                         n_regression)
        return {"trained": tr._asdict(), "backtest_shape": backtest_shape,
                "backtest": plain.backtest(ar, c, inp, tr.a2, tr.b2, S,
                                           H)._asdict()}
    tr = plain.train(ar, c, plain.head(inp, T_hist), n_regression)
    s_hist = plain.historic_states(ar, c, inp, tr.a2, tr.b2, T_hist)
    ans = {"trained": tr._asdict(), "s_hist": s_hist}
    if "scenarios" in stages:
        ans["scenarios"] = plain.scenarios(ar, c, inp, tr.a2, tr.b2, s_hist,
                                           T_hist)
    if "sweep" in stages:
        sw = plain.sweep(ar, c, inp, tr.a2, tr.b2, s_hist,
                         eps[eps_idx].to(ar.dtype).to(inp.obs.device),
                         T_hist)
        ans["sweep"] = dict(sampled=eps_idx, given=eps_idx, u=sw.u,
                            J0=sw.J0, J1=sw.J1)
    if "mc" in stages:
        ans["mc"] = plain.monte_carlo(ar, c, inp, tr.a2, tr.b2, s_hist,
                                      u_random.to(ar.dtype), T_hist)
    return ans
