"""The port's NumPy-only data layer against the JAX package's, and the
port's import hygiene.

epidemicmodeling_torch.data holds copies of the JAX package's preprocessing
(which cannot be imported without pandas and jax) and a DataFrame-free
synthetic generator; on the same inputs they must give identical arrays.
The port must import no jax, jaxlib, flax, pandas or epidemicmodeling_tpu
anywhere: the machine that runs it has none of them.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.data import preprocess as jax_pre
from epidemicmodeling_tpu.pipelines import PipelineConfig as JaxConfig

from epidemicmodeling_torch.data import preprocess as port_pre
from epidemicmodeling_torch.data import synthetic_regions
from epidemicmodeling_torch.pipelines import PipelineConfig

PORT_ROOT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "epidemicmodeling_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "pandas", "epidemicmodeling_tpu"}


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_regions_match_jax_truth(seed):
    _, _, ref = synthetic_oxford_frame(n_regions=5, n_days=130, seed=seed)
    got = synthetic_regions(n_regions=5, n_days=130, seed=seed)
    assert list(got) == list(ref)
    for name in ref:
        assert set(got[name]) == set(ref[name])
        for k, v in ref[name].items():
            np.testing.assert_array_equal(np.asarray(got[name][k]),
                                          np.asarray(v), err_msg=k)


def _noisy_series(seed, T=90, P=12):
    """Case and NPI series with the pathologies the cleaning handles:
    negative revisions, NaN holes, a trailing NaN, NaN NPI runs."""
    rng = np.random.default_rng(seed)
    confirmed = np.cumsum(rng.poisson(50, T)).astype(float)
    confirmed[T // 2:] -= 30.0
    confirmed[[10, 11, 40]] = np.nan
    confirmed[-1] = np.nan
    deaths = 0.01 * confirmed
    npis = rng.integers(0, 4, (T, P)).astype(float)
    npis[5:12, 3] = np.nan
    npis[:4, 7] = np.nan
    return confirmed, deaths, npis, float(rng.integers(10 ** 6, 10 ** 8))


@pytest.mark.parametrize("seed", [0, 7])
def test_preprocess_and_batch_match_jax(seed):
    for mod in (jax_pre, port_pre):
        assert mod.OXFORD_NPI_COLUMNS == jax_pre.OXFORD_NPI_COLUMNS
        np.testing.assert_array_equal(mod.NPI_MAXES_DEFAULT,
                                      jax_pre.NPI_MAXES_DEFAULT)
    out = {}
    for tag, mod in (("jax", jax_pre), ("port", port_pre)):
        sers = []
        for r in range(3):
            c, d, u, pop = _noisy_series(seed * 10 + r, T=90 - 7 * r)
            sers.append(mod.preprocess_region(c, d if r else None, u, pop,
                                              smoothing_win=7 - 2 * r))
        names = [f"R{r} " for r in range(3)]
        out[tag] = (sers, [mod.build_region_batch(sers, names, obs_type=ot,
                                                  horizon=h)
                           for ot in ("NEWCASES", "TOTALCASES")
                           for h in (0, 11)])
        c, _, u, _ = _noisy_series(seed)
        out[tag] += (mod.clean_case_series(c), mod.forward_fill_npis(u),
                     mod._causal_ma(np.arange(20.0), 7),
                     mod._filtfilt_ma(np.sin(np.arange(50.0)), 4))
    ref, got = out["jax"], out["port"]
    for a, b in zip(ref[0], got[0]):
        for k in a._fields:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=k)
    for a, b in zip(ref[1], got[1]):
        for k in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(b, k)),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
    np.testing.assert_array_equal(got[2][0], ref[2][0])
    assert got[2][1] == ref[2][1]
    for k in (3, 4, 5):
        np.testing.assert_array_equal(got[k], ref[k])


def test_pipeline_config_matches_jax():
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}
    assert got == ref
    for prop in ("gamma_model", "beta_model", "alpha0"):
        assert getattr(PipelineConfig(), prop) == getattr(JaxConfig(), prop)
    with pytest.raises(dataclasses.FrozenInstanceError):
        PipelineConfig().dt = 2.0


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_or_pandas():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT_ROOT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(os.path.dirname(PORT_ROOT), "chip_smoke.py"))
    assert len(files) > 15
    bad = [(os.path.relpath(f, os.path.dirname(PORT_ROOT)), mod)
           for f in files for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad
