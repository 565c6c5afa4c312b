"""The XPRIZE request in float64, as the MATLAB reference computes it, on the
CPU: run_pipeline against the benchmark's plain reference
(benchmark/reference/plain.py) on the same inputs; the card route handing
the EKS kernels the caller's dtype (float32 or float64, nothing else); the
spans and counters of run_pipeline's recording."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from epidemicmodeling_torch.control import epsilon_grid
from epidemicmodeling_torch.control.pareto import random_npi_schedules
from epidemicmodeling_torch.data import NPI_MAXES_DEFAULT
from epidemicmodeling_torch.ops.cuda import (build, ekf3_kernel, ekf6_kernel,
                                             nnls_kernel, rollout_kernel,
                                             stencil_kernel)
from epidemicmodeling_torch.pipelines import PipelineConfig
from epidemicmodeling_torch.pipelines.train_predict_prescribe import \
    run_pipeline
from epidemicmodeling_torch.utils.profiling import recording
from tests._torch_helpers import reference_gaps, small_region_inputs


# ------------------------------------------- the request against the reference

T_HIST, H = 120, 20
REF = (np.zeros(12), NPI_MAXES_DEFAULT, np.ones(12))


@pytest.fixture(scope="module")
def f64_request():
    """run_pipeline in float64 at 12 regions over 120 + 20 days, 16
    epsilons, 16 Monte-Carlo schedules: (result, batch_full, actual NPIs,
    epsilons, schedules, config)."""
    bt, bf, actual = small_region_inputs(n_regions=12, t_hist=T_HIST,
                                         horizon=H)
    cfg = PipelineConfig(backend="pallas", pareto_chunk=4,
                         num_monte_carlo=16)
    eps = epsilon_grid(16).numpy()
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 16,
                                    np.zeros(12), NPI_MAXES_DEFAULT, H,
                                    dtype=torch.float64)
    res = run_pipeline(bt, bf, actual, T_HIST, np.ones(12), eps,
                       np.zeros(12), NPI_MAXES_DEFAULT, T_HIST, cfg,
                       dtype=torch.float64, device="cpu", u_random=u_random)
    return res, bf, actual, eps, u_random, cfg


def _gaps(res, bf, actual, eps, u_random, cfg):
    return reference_gaps(res, bf, actual, T_HIST, eps, u_random, cfg, *REF)


def test_run_pipeline_in_float64_matches_the_reference(f64_request):
    """The float64 request held stage by stage against the benchmark's
    plain reference (benchmark/reference/plain.py) on the same inputs
    (reference_gaps): here every smoothed costate of the reference is
    finite and the control switches (u_max on ~11% of the cells at epsilon
    = 1e-12), so the program (the kernels' plain versions on the CPU) and
    the reference compute the same float64 arithmetic in orders that differ
    at most in the last bits.
    Tolerances, each with its reason: the prescriptions exactly (a
    bang-bang cell flips only where phi lies within rounding of 0, and none
    does here); the front exactly (membership from the program's own
    costs); J0/J1 of the sweep, of its prescriptions scored again, of the
    scenarios and of the Monte Carlo, the historic states and the trained
    coefficients against the reference's own training, within 1e-12
    relative (a few float64 ulps of sums over up to 140 days, or of the
    NNLS's solves; they read <= 2.3e-14; this seed's regressions are not
    degenerate, so both NNLS land on one active set)."""
    g = _gaps(*f64_request)
    assert g["costate_nonfinite"] == 0.0
    assert g["u_max_share_first_eps"] > 0.05          # the control switches
    assert g["sweep_flips"] == 0 and g["front_mismatch"] == 0
    for name in ("sweep_cost", "sweep_score", "scenarios", "mc", "s_hist",
                 "train_own"):
        assert g[name] <= 1e-12, (name, g[name])


def _flip_one(u):
    u = u.clone()
    u[3, 5, 7, 2] = NPI_MAXES_DEFAULT[2] - u[3, 5, 7, 2]
    return u


def _drop_first(front):
    front = front.clone()
    front.view(-1)[int(torch.nonzero(front.view(-1))[0])] = False
    return front


# a fault planted in one stage's answer, and the number that must see it
FAULTS = {
    "s_hist_one_day_over": (lambda r: r._replace(
        s_hist=torch.roll(r.s_hist, 1, dims=1)), "s_hist"),
    "a2_scaled": (lambda r: r._replace(trained=r.trained._replace(
        a2=r.trained.a2 * 1.001)), "s_hist"),
    "one_cell_prescribed_otherwise": (lambda r: r._replace(pareto={
        **r.pareto, "u_prescribed": _flip_one(r.pareto["u_prescribed"])}),
        "sweep_flips"),
    "sweep_J0_of_another_epsilon": (lambda r: r._replace(pareto={
        **r.pareto, "J0": torch.roll(r.pareto["J0"], 1, dims=0)}),
        "sweep_cost"),
    "monte_carlo_J1_scaled": (lambda r: r._replace(monte_carlo={
        **r.monte_carlo, "J1": r.monte_carlo["J1"] * (1 + 1e-9)}), "mc"),
    "front_one_member_dropped": (lambda r: r._replace(
        pareto_front=_drop_first(r.pareto_front)), "front_mismatch"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_reference_gaps_see_a_planted_fault(f64_request, fault):
    """Each planted fault reads above the tolerance of the number that
    holds its stage: the comparison above can fail."""
    res, *rest = f64_request
    plant, name = FAULTS[fault]
    g = _gaps(plant(res), *rest)
    assert g[name] > (0 if name in ("sweep_flips", "front_mismatch")
                      else 1e-12), (fault, g[name])


# ------------------------------------------------------ the dtype on the card

@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.float64, "_f64")])
@pytest.mark.parametrize("entry", ["ekf3_smoother", "ekf6_forward",
                                   "ekf6_backward", "nnls_intercept",
                                   "nnls_masked_solve", "rollout",
                                   "stencil_rollout"])
def test_card_entry_is_the_callers_precision(entry, dtype, suffix):
    """build.instance picks the C entry of the caller's precision, one its
    wrapper declares. The EKS kernels' float entries have no suffix; every
    other entry carries its instance's, _f32 or _f64."""
    name = build.instance(entry, dtype)
    if not entry.startswith("ekf"):
        suffix = "_f32" if dtype == torch.float32 else "_f64"
    assert name == entry + suffix
    sigs = {**ekf3_kernel._SIGNATURES, **ekf6_kernel._SIGNATURES,
            **nnls_kernel._SIGNATURES, **rollout_kernel._SIGNATURES,
            **stencil_kernel._SIGNATURES}
    floats = [a for a in sigs[name] if a in (ekf3_kernel._F,
                                             ekf3_kernel._D)]
    # the scalars of an entry are of its instance's width
    want = ekf3_kernel._D if dtype == torch.float64 else ekf3_kernel._F
    assert all(a is want for a in floats)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32, torch.complex64])
def test_card_entry_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or float64"):
        build.instance("ekf3_smoother", dtype)


def _pipeline(dtype, bt, bf, actual, T_hist=60, n_eps=8):
    cfg = PipelineConfig(backend="pallas", pareto_chunk=4,
                         num_monte_carlo=8)
    return run_pipeline(bt, bf, actual, T_hist, np.ones(12),
                        epsilon_grid(n_eps).numpy(), np.zeros(12),
                        NPI_MAXES_DEFAULT, T_hist, cfg,
                        generator=torch.Generator().manual_seed(0),
                        dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_stages_hand_the_kernels_the_callers_dtype(dtype, monkeypatch):
    """Every EKS call of run_pipeline on the kernels' route receives the
    caller's dtype, and its outputs keep it: no cast on the way to the
    kernels or back (the route is the card's; on the CPU the kernels'
    wrappers run the plain versions, which are recorded here)."""
    seen = {"ekf3": [], "ekf6": []}
    for mod, name in ((ekf3_kernel, "ekf3"), (ekf6_kernel, "ekf6")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen[_name].append({a.dtype for a in args})
            outs = _real(*args, **kw)
            seen[_name].append({o.dtype for o in outs})
            return outs
        monkeypatch.setattr(mod, name, spy)
    bt, bf, actual = small_region_inputs()
    res = _pipeline(dtype, bt, bf, actual)
    assert len(seen["ekf3"]) == 2 * 4 and len(seen["ekf6"]) == 2 * 2
    assert all(s == {dtype} for v in seen.values() for s in v)
    assert res.pareto["J0"].dtype == dtype
    assert res.s_hist.dtype == dtype


# --------------------------------------------------- spans and counters

TREE = ([("pipeline", None), ("pipeline.train", "pipeline"),
         ("train.init", "pipeline.train"), ("train.ekf3", "pipeline.train"),
         ("train.regress", "pipeline.train"),
         ("train.ekf3", "pipeline.train"),
         ("train.regress", "pipeline.train"),
         ("pipeline.forecast", "pipeline"), ("pareto", "pipeline")]
        + [("pareto.chunk", "pareto"), ("pareto.ekf6", "pareto.chunk"),
           ("pareto.rollout", "pareto.chunk"),
           ("pareto.score", "pareto.chunk")] * 2
        + [("mc", "pipeline"), ("front", "pipeline")])


@pytest.fixture(scope="module")
def recorded():
    bt, bf, actual = small_region_inputs()
    off = _pipeline(torch.float64, bt, bf, actual)
    with recording() as rec:
        on = _pipeline(torch.float64, bt, bf, actual)
    return off, on, rec


def test_run_pipeline_span_tree(recorded):
    _, _, rec = recorded
    spans = rec.spans
    assert rec.requests == 1
    assert [(s["name"], None if s["parent"] is None
             else spans[s["parent"]]["name"]) for s in spans] == TREE
    for s in spans:
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_costate_counter_and_the_same_outputs(recorded):
    off, on, rec = recorded
    # every smoothed costate of this small case is finite; the count is
    # read when the recording closes, and the recording moves no output
    assert rec.counters["ekf6.costate_nonfinite"] == 0
    for k in ("J0", "J1", "u_prescribed"):
        assert torch.equal(off.pareto[k], on.pareto[k]), k
    assert torch.equal(off.pareto_front, on.pareto_front)


def test_costate_counter_counts_what_is_not_finite(monkeypatch):
    """Costates made non-finite on purpose are counted, over every lane."""
    real = ekf6_kernel.ekf6

    def poisoned(*args, **kw):
        s_sm, u_sm, sp = real(*args, **kw)
        s_sm = s_sm.clone()
        s_sm[:5, 3:] = float("nan")           # 5 steps x 3 costates a lane
        s_sm[:5, :3] = float("inf")           # states: not counted
        return s_sm, u_sm, sp
    monkeypatch.setattr(ekf6_kernel, "ekf6", poisoned)
    bt, bf, actual = small_region_inputs()
    with recording() as rec:
        _pipeline(torch.float64, bt, bf, actual)
    lanes = 8 * 3                              # 2 chunks of 4 eps x 3 regions
    assert rec.counters["ekf6.costate_nonfinite"] == 5 * 3 * lanes
