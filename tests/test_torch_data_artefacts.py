"""The port's pandas-free realistic-artefact frames, OxCGRT_latest schema
and JHU reader against the JAX package's pandas versions.

The frames are compared cell by cell: every numeric cell bit for bit
(NaN exactly where the JAX frame has NaN), every text cell equal, with the
port's None standing for the JAX frame's NaN in RegionName. The JHU
reader's sums are compared the same way (NumPy sums of the same parsed
values in the same order).
"""

import numpy as np
import pandas as pd
import pytest

from epidemicmodeling_tpu.data import jhu as jax_jhu
from epidemicmodeling_tpu.data import synthetic as jax_syn

from epidemicmodeling_torch.data import (OXCGRT_LATEST_COLUMNS,
                                         load_geo_list, load_oxford_data,
                                         load_populations,
                                         realistic_oxford_frame,
                                         to_oxcgrt_latest_schema,
                                         write_oxford_csvs)
from epidemicmodeling_torch.data.csvio import read_csv_columns
from epidemicmodeling_torch.data.jhu import read_covid19_data
from epidemicmodeling_torch.pipelines import build_batches_from_frames


def _assert_frame_equal(got: dict, ref: pd.DataFrame):
    assert list(got) == list(ref.columns)
    for col in ref.columns:
        r = ref[col].to_numpy()
        g = got[col]
        assert len(g) == len(r), col
        if col == "RegionName":
            # NaN in the JAX frame, None in the port's
            assert ref[col].isna().all() and all(v is None for v in g)
        elif ref[col].dtype.kind in "fiu":
            g = np.asarray(g)
            assert g.dtype.kind == ref[col].dtype.kind, col
            np.testing.assert_array_equal(np.isnan(g.astype(float)),
                                          np.isnan(r.astype(float)),
                                          err_msg=col)
            np.testing.assert_array_equal(g, r, err_msg=col)
        else:
            g = [None if v is None else v for v in g]
            r = [None if (isinstance(v, float) and np.isnan(v)) else v
                 for v in r]
            assert g == r, col


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("size", [(4, 200), (3, 60)],
                         ids=["late_start", "short"])
def test_realistic_frame_matches_jax(seed, size):
    """(4, 200): region 1 starts late (n_days > 80); (3, 60): it does
    not."""
    n_regions, n_days = size
    ref_df, ref_pops, ref_truth = jax_syn.realistic_oxford_frame(
        n_regions, n_days, seed=seed)
    frame, pops, truth = realistic_oxford_frame(n_regions, n_days,
                                                seed=seed)
    _assert_frame_equal(frame, ref_df)
    _assert_frame_equal(pops, ref_pops)
    assert list(truth) == list(ref_truth)
    for name in ref_truth:
        np.testing.assert_array_equal(truth[name]["confirmed_clean"],
                                      ref_truth[name]["confirmed_clean"])
    cases = np.asarray(frame["ConfirmedCases"]).reshape(n_regions, n_days)
    assert np.isnan(cases[0, -1])
    assert np.isnan(cases[1, :40]).all() == (n_days > 80)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("states", [False, True],
                         ids=["national", "with_states"])
def test_latest_schema_matches_jax(seed, states):
    """National rows only, and with region 1 a state ("Ontario"): its
    RegionCode and Jurisdiction take the state branch."""
    ref_src, _, _ = jax_syn.realistic_oxford_frame(3, 90, seed=seed)
    src, _, _ = realistic_oxford_frame(3, 90, seed=seed)
    if states:
        ref_src["RegionName"] = ref_src["RegionName"].astype(object)
        ref_src.loc[90:179, "RegionName"] = "Ontario"
        src["RegionName"] = [None] * 90 + ["Ontario"] * 90 + [None] * 90
    got = to_oxcgrt_latest_schema(src, seed=seed)
    ref = jax_syn.to_oxcgrt_latest_schema(ref_src, seed=seed)
    if states:
        assert got["RegionCode"][90] == "SY_ON"
        assert got["Jurisdiction"][90] == "STATE_TOTAL"
        for col in ("RegionName", "RegionCode", "Jurisdiction"):
            r = [None if isinstance(v, float) else v for v in ref[col]]
            assert list(got.pop(col)) == r, col
            ref = ref.drop(columns=col)
    _assert_frame_equal(got, ref)


def test_latest_schema_loads_as_the_minimal_file(tmp_path):
    """The port's loaders read the widened file as the minimal one: the
    training and full-horizon batches and the actual NPIs of every region,
    bit for bit."""
    frame, pops, _ = realistic_oxford_frame(3, 120, seed=2)
    for d in ("small", "wide"):
        (tmp_path / d).mkdir()
    small = write_oxford_csvs(tmp_path / "small", frame, pops)
    wide = write_oxford_csvs(tmp_path / "wide",
                             to_oxcgrt_latest_schema(frame, seed=4), pops)
    assert len(read_csv_columns(wide["data"])) == len(OXCGRT_LATEST_COLUMNS)
    out = []
    for files in (small, wide):
        table = load_oxford_data(files["data"], None, "2020-03-01",
                                 "2020-06-28")
        out.append(build_batches_from_frames(
            table, load_populations(files["populations"]),
            load_geo_list(files["geos"]), "2020-03-01", "2020-05-29",
            "2020-06-28"))
    assert out[0][0].observations.shape == (3, 90)
    for a, b in zip(*out):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif hasattr(a, "_fields"):
            for f in a._fields:
                x, y = getattr(a, f), getattr(b, f)
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype, f
                    np.testing.assert_array_equal(x, y, err_msg=f)
                else:
                    assert x == y, f
        else:
            assert a == b


def _write_jhu(tmp_path):
    """Three JHU-schema files: a quoted name with a comma, a country split
    into provinces, a name that is a substring of another ("Niger" /
    "Nigeria"), an empty cell."""
    dates = ["1/22/20", "1/23/20", "1/24/20", "1/25/20", "1/26/20"]
    rows = [("", "Korea, South", 36.0, 128.0, [0, 1, 2, 4, 7]),
            ("Hubei", "China", 30.9, 112.2, [444, 444, 549, 761, 1058]),
            ("Beijing", "China", 40.1, 116.4, [14, 22, 36, 41, 68]),
            ("", "Niger", 17.6, 8.1, [0, 0, 0, 1, 1]),
            ("", "Nigeria", 9.1, 8.7, [0, 0, 1, 1, 2]),
            ("", "Italy", 41.9, 12.6, [0, 0, None, 2, 3])]
    paths = []
    for k, scale in enumerate((1.0, 0.03, 0.5)):
        path = tmp_path / f"jhu_{k}.csv"
        with open(path, "w") as f:
            f.write("Province/State,Country/Region,Lat,Long,"
                    + ",".join(dates) + "\n")
            for prov, country, lat, lon, vals in rows:
                cells = ["" if v is None else repr(round(v * scale, 2))
                         for v in vals]
                name = f'"{country}"' if "," in country else country
                f.write(",".join([prov, name, repr(lat), repr(lon)] + cells)
                        + "\n")
        paths.append(str(path))
    return paths


def test_read_covid19_data_matches_jax(tmp_path):
    paths = _write_jhu(tmp_path)
    regions = ["Korea, South", "China", "Niger", "Italy", "Atlantis"]
    ref = jax_jhu.read_covid19_data(*paths, regions, min_cases=2.0)
    got = read_covid19_data(*paths, regions, min_cases=2.0)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    # "Niger" also takes "Nigeria"'s row; Italy's empty cell is NaN
    assert got["TotalCases"][2, -1] == 3.0
    assert np.isnan(got["TotalCases"][3, 2])
