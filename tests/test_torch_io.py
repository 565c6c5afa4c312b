"""The port's pandas-free file layer against the JAX package's pandas one.

CSV files written by pandas (from the JAX package's synthetic_oxford_frame,
realistic_oxford_frame and to_oxcgrt_latest_schema) go through both
packages' loaders and build_batches_from_frames; the batches must agree bit
for bit (the port reproduces pandas' own float parser, data/csvio.py). Then
the writers (byte for byte for prescriptions), read_future_ip, and the
.npz/.mat checkpoint files across packages in both directions.
"""

import filecmp
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from epidemicmodeling_tpu.data import (OXFORD_NPI_COLUMNS,
                                       realistic_oxford_frame,
                                       synthetic_oxford_frame)
from epidemicmodeling_tpu.data import oxford as jax_oxford
from epidemicmodeling_tpu.data import xprize_io as jax_io
from epidemicmodeling_tpu.data.synthetic import to_oxcgrt_latest_schema
from epidemicmodeling_tpu.pipelines import PipelineConfig as JaxConfig
from epidemicmodeling_tpu.pipelines import checkpoint as jax_ckpt
from epidemicmodeling_tpu.pipelines.core import \
    TrainedRegionParams as JaxTrained
from epidemicmodeling_tpu.pipelines.train_predict_prescribe import \
    build_batches_from_frames as jax_build

from epidemicmodeling_torch.data import oxford, xprize_io
from epidemicmodeling_torch.data.csvio import (parse_floats,
                                               read_csv_columns)
from epidemicmodeling_torch.data.synthetic import (
    synthetic_oxford_frame as port_frame, write_oxford_csvs)
from epidemicmodeling_torch.pipelines import PipelineConfig, checkpoint
from epidemicmodeling_torch.pipelines import build_batches_from_frames

START, END, END_PRED = "2020-03-01", "2020-08-17", "2020-09-16"


def _with_regions(df, pops):
    """Synthland1 and Synthland2 become sub-national regions."""
    df, pops = df.copy(), pops.copy()
    for frame in (df, pops):
        frame["RegionName"] = frame["RegionName"].astype(object)
        for k, region in ((1, "North"), (2, "South, East")):
            frame.loc[frame["CountryName"] == f"Synthland{k}",
                      "RegionName"] = region
    return df, pops


def _iso_dates(df):
    df = df.copy()
    df["Date"] = pd.to_datetime(df["Date"].astype(str),
                                format="%Y%m%d").dt.strftime("%Y-%m-%d")
    return df


def _na_strings(df):
    """pandas' NA spellings in numeric and text columns, a missing
    RegionName and ConfirmedDeaths column, and a row order shuffled."""
    df = df.drop(columns=["RegionName", "ConfirmedDeaths"]).astype(object)
    rng = np.random.default_rng(3)
    for k, na in enumerate(("NA", "N/A", "null", "NaN", "nan", "#N/A",
                            "<NA>", "None")):
        rows = rng.integers(20, len(df), 3)
        df.iloc[rows, df.columns.get_loc(OXFORD_NPI_COLUMNS[k])] = na
        df.iloc[rows[:1], df.columns.get_loc("ConfirmedCases")] = na
    return df.iloc[rng.permutation(len(df))]


def _frame(kind):
    if kind == "realistic":
        return realistic_oxford_frame(n_regions=4, n_days=200, seed=7)[:2]
    df, pops, _ = synthetic_oxford_frame(n_regions=4, n_days=200, seed=9)
    if kind == "latest_schema":
        return to_oxcgrt_latest_schema(df, seed=2), pops
    if kind == "iso_dates_regions":
        df, pops = _with_regions(_iso_dates(df), pops)
    if kind == "na_strings":
        df = _na_strings(df)
    return df, pops


KINDS = ["synthetic", "realistic", "latest_schema", "iso_dates_regions",
         "na_strings"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = {}
    for kind in KINDS:
        tmp = tmp_path_factory.mktemp(kind)
        df, pops = _frame(kind)
        df.to_csv(tmp / "oxford.csv", index=False)
        pops.to_csv(tmp / "populations.csv", index=False)
        pops[["CountryName", "RegionName"]].to_csv(tmp / "geos.csv",
                                                   index=False)
        out[kind] = {k: str(tmp / f"{f}.csv") for k, f in
                     (("data", "oxford"), ("populations", "populations"),
                      ("geos", "geos"))}
    return out


def _both_batches(f, start=START, end=END, end_pred=END_PRED):
    geos_j = jax_oxford.load_geo_list(f["geos"])
    geos_p = oxford.load_geo_list(f["geos"])
    assert geos_p == geos_j
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ref = jax_build(jax_oxford.load_oxford_data(f["data"], None, start,
                                                    end_pred),
                        jax_oxford.load_populations(f["populations"]),
                        geos_j, start, end, end_pred, None, JaxConfig())
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        got = build_batches_from_frames(
            oxford.load_oxford_data(f["data"], None, start, end_pred),
            oxford.load_populations(f["populations"]), geos_p, start, end,
            end_pred, None, PipelineConfig())
    assert [str(w.message) for w in wp] == [str(w.message) for w in wj]
    return ref, got


@pytest.mark.parametrize("kind", KINDS)
def test_batches_from_csv_match_jax_bit_for_bit(files, kind):
    ref, got = _both_batches(files[kind])
    for b_ref, b_got in zip(ref[:2], got[:2]):
        assert tuple(b_got.names) == tuple(b_ref.names)
        for f in b_ref._fields:
            if f != "names":
                np.testing.assert_array_equal(
                    np.asarray(getattr(b_got, f)),
                    np.asarray(getattr(b_ref, f)), err_msg=f)
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[3:] == ref[3:]


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_table_matches_jax(files, kind):
    """load_oxford_data: same rows, same sort, same values (NaN where pandas
    reads missing), with and without the date crop."""
    for crop in ((None, None), ("2020-04-02", "2020-07-30")):
        ref = jax_oxford.load_oxford_data(files[kind]["data"], None, *crop)
        got = oxford.load_oxford_data(files[kind]["data"], None, *crop)
        assert got.geo_id == list(ref["GeoID"])
        np.testing.assert_array_equal(got.date_num, ref["DateNum"])
        np.testing.assert_array_equal(got.confirmed, ref["ConfirmedCases"])
        np.testing.assert_array_equal(got.deaths, ref["ConfirmedDeaths"])
        np.testing.assert_array_equal(
            got.npis, ref[OXFORD_NPI_COLUMNS].to_numpy(float))
        gid = got.geo_id[-1]
        for a, b in zip(oxford.region_arrays(got, gid),
                        jax_oxford.region_arrays(ref, gid)):
            np.testing.assert_array_equal(a, b)


def test_float_parser_is_pandas_bit_for_bit(tmp_path):
    """Shortest round-trip, fixed 20-decimal and 25-digit exponent forms
    over 30 decades, plus edge spellings: the port's parser gives pandas'
    value where Python's float() differs in the last bit."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000)
    strs = ([repr(float(x)) for x in v] + [f"{x:.20f}" for x in v[:800]]
            + [f"{x:.25e}" for x in v[:800]]
            + ["1e400", "-1e-400", "0.0000000000000000000012345",
               "123456789012345678901234", "1E5", "+3.5", "-0", ".5", "5.",
               "1e-320", " 7.25 ", "inf", "-Infinity", "NA", ""])
    pd.DataFrame({"x": strs}).to_csv(tmp_path / "x.csv", index=False)
    ref = pd.read_csv(tmp_path / "x.csv")["x"].to_numpy(float)
    got = parse_floats(read_csv_columns(tmp_path / "x.csv")["x"])
    np.testing.assert_array_equal(got, ref)
    assert sum(float(s) != r for s, r in zip(strs[:5600], ref)) > 100
    with pytest.raises(ValueError, match="not a number"):
        parse_floats(["1.5", "1.5x"])


def test_loader_errors_match_jax(tmp_path, files):
    """A missing column, a duplicate date and a calendar gap raise the JAX
    loader's ValueError; a date in neither accepted format raises one that
    names both."""
    df, pops = _frame("synthetic")
    pops.to_csv(tmp_path / "pop.csv", index=False)
    cases = {
        "missing required columns": df.drop(columns=[OXFORD_NPI_COLUMNS[3]]),
        "duplicate rows for date": pd.concat([df, df.iloc[[30]]]),
        "calendar gap": df.drop(index=[40, 41]),
    }
    geos = jax_oxford.load_geo_list(files["synthetic"]["geos"])
    for match, bad in cases.items():
        path = tmp_path / "bad.csv"
        bad.to_csv(path, index=False)
        for load, build, pops_of, cfg in (
                (jax_oxford.load_oxford_data, jax_build,
                 jax_oxford.load_populations, JaxConfig()),
                (oxford.load_oxford_data, build_batches_from_frames,
                 oxford.load_populations, PipelineConfig())):
            with pytest.raises(ValueError, match=match):
                build(load(path, None, START, END_PRED),
                      pops_of(tmp_path / "pop.csv"), geos, START, END,
                      END_PRED, None, cfg)
    df = df.astype({"Date": str})
    df["Date"] = df["Date"].str[4:6] + "/" + df["Date"].str[6:] + "/" \
        + df["Date"].str[:4]
    df.to_csv(tmp_path / "us_dates.csv", index=False)
    with pytest.raises(ValueError, match="YYYYMMDD integers or ISO dates"):
        oxford.load_oxford_data(tmp_path / "us_dates.csv")


def test_populations_geos_costs_match_jax(tmp_path, files):
    f = files["iso_dates_regions"]
    ref = jax_oxford.load_populations(f["populations"])
    got = oxford.load_populations(f["populations"])
    assert list(got) == list(ref.index)
    np.testing.assert_array_equal(list(got.values()),
                                  ref["Population2020"].to_numpy())
    costs = pd.read_csv(f["geos"], dtype=str)
    rng = np.random.default_rng(4)
    for c in OXFORD_NPI_COLUMNS:
        costs[c] = rng.uniform(0.5, 2.0, len(costs)).round(3)
    costs = pd.concat([costs, costs.iloc[[0]].assign(
        **{OXFORD_NPI_COLUMNS[0]: 9.0})])           # a geo listed twice
    costs.to_csv(tmp_path / "costs.csv", index=False)
    geos = ["Nowhere "] + oxford.load_geo_list(f["geos"])
    np.testing.assert_array_equal(
        oxford.load_npi_costs(tmp_path / "costs.csv", geos),
        jax_oxford.load_npi_costs(tmp_path / "costs.csv", geos))


def test_synthetic_frame_and_csvs_match_jax(tmp_path):
    """The port's synthetic frame holds the JAX frame's values, and its
    CSVs are byte for byte pandas' to_csv of the JAX frame."""
    df, pops, _ = synthetic_oxford_frame(n_regions=3, n_days=75, seed=11)
    frame, port_pops, _ = port_frame(n_regions=3, n_days=75, seed=11)
    assert list(frame) == list(df.columns)
    for c in df.columns:
        if c == "RegionName":
            assert df[c].isna().all() and set(frame[c]) == {None}
        else:
            np.testing.assert_array_equal(np.asarray(frame[c]), df[c])
    paths = write_oxford_csvs(tmp_path, frame, port_pops)
    df.to_csv(tmp_path / "ref_oxford.csv", index=False)
    pops.to_csv(tmp_path / "ref_populations.csv", index=False)
    pops[["CountryName", "RegionName"]].to_csv(tmp_path / "ref_geos.csv",
                                               index=False)
    for k, ref in (("data", "ref_oxford"), ("populations", "ref_populations"),
                   ("geos", "ref_geos")):
        assert filecmp.cmp(paths[k], tmp_path / f"{ref}.csv", shallow=False)


def test_writers_match_jax(tmp_path):
    """Prescriptions byte for byte (integer levels, empty and quoted region
    names); predictions with the same values (and here the same bytes)."""
    rng = np.random.default_rng(5)
    geos = ["Aland ", "Borduria North", "Syldavia South, East"]
    u = rng.integers(0, 5, (2, 3, 6, 12)) + rng.choice([0.0, 0.5, 0.4999],
                                                       (2, 3, 6, 12))
    pred = rng.random((3, 6)) * 10.0 ** rng.integers(-3, 8, (3, 6))
    wide = u.copy()
    wide[1, 2, 3, 4], wide[0, 0, 5, 11] = 12.0, -1.0   # not single digits
    for levels in (u, wide):
        jax_io.write_prescriptions_csv(tmp_path / "pj.csv", geos,
                                       "2020-12-30", levels)
        xprize_io.write_prescriptions_csv(tmp_path / "pp.csv", geos,
                                          "2020-12-30",
                                          torch.from_numpy(levels))
        assert filecmp.cmp(tmp_path / "pj.csv", tmp_path / "pp.csv",
                           shallow=False)
    for flag in (False, True):
        jax_io.write_predictions_csv(tmp_path / "qj.csv", geos, "2020-02-28",
                                     pred, is_specialty=flag)
        xprize_io.write_predictions_csv(tmp_path / "qp.csv", geos,
                                        "2020-02-28", pred, is_specialty=flag)
        a, b = pd.read_csv(tmp_path / "qj.csv"), pd.read_csv(tmp_path /
                                                              "qp.csv")
        pd.testing.assert_frame_equal(a, b)
        assert filecmp.cmp(tmp_path / "qj.csv", tmp_path / "qp.csv",
                           shallow=False)


def test_read_future_ip_matches_jax(tmp_path):
    """Forward-fill across missing days, zero before the first entry, rows
    outside the window ignored, NaN cells filled, unknown geos all zero."""
    rng = np.random.default_rng(6)
    rows = []
    for geo, region in (("Aland", ""), ("Borduria", "North")):
        for d in ("2020-12-28", "2021-01-02", "2021-01-05", "2021-01-09",
                  "2021-02-01"):
            lv = rng.integers(0, 4, 12).astype(float)
            lv[rng.integers(0, 12)] = np.nan
            rows.append([geo, region, d] + list(lv))
    df = pd.DataFrame(rows, columns=["CountryName", "RegionName", "Date"]
                      + OXFORD_NPI_COLUMNS)
    df.to_csv(tmp_path / "ip.csv", index=False)
    geos = ["Aland ", "Nowhere ", "Borduria North"]
    args = (geos, "2021-01-01", "2021-01-20")
    ref = jax_io.read_future_ip(tmp_path / "ip.csv", *args)
    got = xprize_io.read_future_ip(tmp_path / "ip.csv", *args)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (3, 20, 12) and not got[1].any()


@pytest.mark.parametrize("fmt", ["npz", "mat"])
def test_checkpoints_load_across_packages(tmp_path, fmt):
    """A file written by either package loads in the other with the same
    names and coefficients."""
    rng = np.random.default_rng(8)
    names = ("Aland ", "Borduria North", "Syldavia ")
    fields = dict(population=rng.integers(10 ** 6, 10 ** 8, 3).astype(float),
                  a1=rng.random((3, 12)), b1=rng.random(3),
                  a2=rng.random((3, 12)), b2=rng.random(3))
    save_j = getattr(jax_ckpt, "save_trained_params"
                     + ("_mat" if fmt == "mat" else ""))
    load_j = getattr(jax_ckpt, "load_trained_params"
                     + ("_mat" if fmt == "mat" else ""))
    port = checkpoint.trained_params_from_numpy(dict(names=names, **fields))
    save_j(tmp_path / f"j.{fmt}", JaxTrained(names=names, **fields))
    checkpoint.save_checkpoint(tmp_path / f"p.{fmt}", port)
    for loaded in (checkpoint.load_checkpoint(tmp_path / f"j.{fmt}"),
                   checkpoint.load_checkpoint(tmp_path / f"p.{fmt}"),
                   load_j(tmp_path / f"p.{fmt}")):
        assert tuple(loaded.names) == names
        for k, v in fields.items():
            got = getattr(loaded, k)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(np.asarray(got), v, err_msg=k)
