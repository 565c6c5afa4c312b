"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU (the kernels' plain versions), at a small
size, with one fault planted in the program each time. The faults: an EKF
step that returns its state unchanged; half of a kernel call's lanes left
out (the first half computed, copied over the rest); an answer altered
where it is produced. One card runs every cell, so no exchange between
chips can be left out. The traffic kinds that have no cell yet, and so no
limits, are held in float64, where a sound run reads under 1e-12: each
fault moves a number far above that."""

import dataclasses
import importlib

import pytest
import torch

from benchmark import run
from benchmark.entries import _xprize
from benchmark.tests.conftest import (CELLS, PAIRS, cut, files_of,
                                      small_files)


def state_unchanged(monkeypatch):
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel, ekf6_kernel
    for mod in (ekf3_kernel, ekf6_kernel):
        real = mod.ekf_smoother_bl

        def broken(system, *a, _real=real, **kw):
            upd = system.nlin_state_update

            def still(u, s, p, k):
                return upd(u, s, p, k)[0], s
            return _real(dataclasses.replace(system,
                                             nlin_state_update=still),
                         *a, **kw)
        monkeypatch.setattr(mod, "ekf_smoother_bl", broken)


def half_the_lanes(monkeypatch):
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel, ekf6_kernel
    for mod, name in ((ekf3_kernel, "ekf3"), (ekf6_kernel, "ekf6")):
        real = getattr(mod, name)

        def broken(*args, _real=real, **kw):
            B = args[0].shape[-1]
            h = (B + 1) // 2
            outs = _real(*(a[..., :h] for a in args), **kw)
            idx = torch.arange(B) % h
            return tuple(o[..., idx] for o in outs)
        monkeypatch.setattr(mod, name, broken)


def answer_altered(monkeypatch):
    from epidemicmodeling_torch.pipelines import (core, forecast_quality,
                                                  prescribe)
    real_par = core.pareto_prescribe

    def par(*a, **kw):
        out = real_par(*a, **kw)
        u = out["u_prescribed"]
        u[:, 0, 0] = torch.where(u[:, 0, 0] == 0, 1.0, 0.0).to(u.dtype)
        return out
    for mod in (core, prescribe):
        monkeypatch.setattr(mod, "pareto_prescribe", par)
    tpp = importlib.import_module(
        "epidemicmodeling_torch.pipelines.train_predict_prescribe")
    monkeypatch.setattr(tpp, "pareto_prescribe", par)
    real_err = forecast_quality._errors_from_states

    def err(*a, **kw):
        ep, es = real_err(*a, **kw)
        es = es.clone()
        es[0, -1, 0] = es[0, -1, 0] * 100.0 + 100.0
        return ep, es
    monkeypatch.setattr(forecast_quality, "_errors_from_states", err)


FAULTS = {"state unchanged": state_unchanged,
          "half the lanes": half_the_lanes,
          "answer altered": answer_altered}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(workload, fault, workdir, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run.run_cell(small_files(workload), 3, 0.0, 0,
                       torch.device("cpu"), workdir)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, workdir):
    res = run.run_cell(small_files(workload), 3, 0.0, 0,
                       torch.device("cpu"), workdir)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("pair", PAIRS, ids="/".join)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_moves_a_number_in_float64(pair, fault, workdir, monkeypatch):
    monkeypatch.setattr(_xprize, "F32", torch.float64)
    FAULTS[fault](monkeypatch)
    res = run.run_cell(cut(files_of(*pair)), 3, 0.0, 0, torch.device("cpu"),
                       workdir)
    assert max(res["numbers"].values()) > 1e-6, res["numbers"]
