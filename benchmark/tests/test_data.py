"""The inputs: the frozen generator and cleaning against the port's, and
where on them the sweep's control switches."""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import plain
from benchmark.tests.conftest import cut, files_of


def test_epsilon_grid_is_the_products():
    from epidemicmodeling_torch.control import epsilon_grid
    for n in (16, 250, 2000):
        assert np.array_equal(data.epsilon_grid(n), epsilon_grid(n).numpy())


def test_arrays_equal_the_ports_cleaning():
    """region_arrays gives the batch that the port's own preprocess_region
    and build_region_batch give for the same generated regions."""
    from epidemicmodeling_torch.data.preprocess import (build_region_batch,
                                                        preprocess_region)
    recipe = cut(files_of("xprize-phase2", "backtest"))["config"]["data"]
    truth = data.regions(recipe, np.random.default_rng(3))
    T_hist, H = recipe["t_hist"], recipe["horizon"]
    arrays = data.region_arrays(truth, T_hist, H)
    sers = [preprocess_region(np.cumsum(t["s"] * t["i"] * t["alpha"]
                                        * t["pop"])[:T_hist], None,
                              t["u"][:T_hist], t["pop"]) for t in truth]
    bf = build_region_batch(sers, [str(r) for r in range(len(truth))],
                            horizon=H)
    for mine, port in (("obs", "observations"),
                       ("new_cases_norm", "new_cases_norm"),
                       ("confirmed_norm", "confirmed_norm"),
                       ("npis", "npis"), ("obs_noise_var", "obs_noise_var"),
                       ("population", "population")):
        np.testing.assert_array_equal(arrays[mine], getattr(bf, port))


@pytest.mark.parametrize("config", ["xprize-phase2", "paper-sweep-2000"])
def test_recipe_is_the_ports_generator(config):
    """The configurations' recipe reproduces synthetic_regions' regions (the
    port's generator at its own constants) from the same draws."""
    import json
    from benchmark.tests.conftest import ROOT
    from epidemicmodeling_torch.data.synthetic import synthetic_regions
    recipe = json.loads((ROOT / "benchmark" / "configs"
                         / f"{config}.json").read_text())["data"]
    recipe = dict(recipe, regions=3, t_hist=100, horizon=20)
    mine = data.regions(recipe, np.random.default_rng(5))
    port = list(synthetic_regions(3, 120, seed=5).values())
    for m, p in zip(mine, port):
        for k in ("a", "b", "pop", "u"):
            np.testing.assert_array_equal(m[k], p[k])
        for k in ("s", "i", "alpha"):
            np.testing.assert_allclose(m[k], p[k], rtol=1e-12, atol=0)


def sweep_ends(t_hist: int, horizon: int, ar) -> tuple:
    """The reference's sweep at both ends of the 250-point grid on 12
    regions of the configuration's recipe and constants: (the u_max share
    of the prescribed cells at each end, the share of smoothed costates
    not finite)."""
    files = cut(files_of("xprize-phase2", "pipeline"), regions=12,
                t_hist=t_hist, horizon=horizon)
    cfg = files["config"]
    arrays = data.input_set(cfg["data"], np.random.default_rng(1))
    c = plain.settings(cfg["pipeline"])
    inp = plain.inputs(arrays, data.NPI_MINS, data.NPI_MAXES,
                       data.NPI_WEIGHTS, ar, "cpu")
    tr = plain.train(ar, c, plain.head(inp, t_hist), t_hist)
    s_hist = plain.historic_states(ar, c, inp, tr.a2, tr.b2, t_hist)
    eps = torch.as_tensor(data.epsilon_grid(250))[[0, 249]].to(ar.dtype)
    sw = plain.sweep(ar, c, inp, tr.a2, tr.b2, s_hist, eps, t_hist)
    share = (sw.u == inp.u_max).double().mean(dim=(1, 2, 3))
    return share.tolist(), sw.costate_nonfinite


def test_both_ends_of_the_grid_differ_at_a_small_size():
    """Over 140 days the control switches: at epsilon = 1e-12 the
    reference prescribes u_max on part of the cells, at epsilon ~ 1 on
    none, every costate finite."""
    (lo, hi), nonfinite = sweep_ends(120, 20, plain.REFERENCE)
    assert lo > 0.05 and hi == 0.0 and nonfinite == 0.0


def test_the_sweep_is_ill_posed_at_the_products_size():
    """Over the product's 532 days at PipelineConfig's constants the
    costates outgrow the formulation: in float64 part of them are not
    finite, and in float32 every epsilon prescribes the same u_max share
    (why the sweep cells wait for a program change, PERF.md)."""
    _, nonfinite = sweep_ends(440, 92, plain.REFERENCE)
    assert nonfinite > 0.0
    (lo, hi), nonfinite32 = sweep_ends(440, 92, plain.Arith(torch.float32))
    assert lo == hi and nonfinite32 > 0.5
