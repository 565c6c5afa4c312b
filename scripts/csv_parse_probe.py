"""How the port's pandas-free CSV loader compares with pandas (CPU only).

    JAX_PLATFORMS=cpu python scripts/csv_parse_probe.py [--regions 235 --days 532]

Writes the JAX package's synthetic and realistic OxCGRT frames with pandas'
to_csv into a temporary directory, then for each file prints
- how many numeric cells Python's float() parses to another double than
  pandas' default C parser does (the reason data/csvio.py reproduces that
  parser), and how many the port's csvio.parse_floats gets wrong (0 is the
  only right answer);
- the best of three walls of load_oxford_data, the port's and the JAX
  package's (pandas), on this machine's CPU.
It needs pandas and the JAX package, so it runs beside the tests, not on the
GPU machine.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pandas as pd

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from epidemicmodeling_tpu.data import (  # noqa: E402
    realistic_oxford_frame, synthetic_oxford_frame)
from epidemicmodeling_tpu.data.oxford import \
    load_oxford_data as jax_load  # noqa: E402

from epidemicmodeling_torch.data.csvio import (  # noqa: E402
    parse_floats, read_csv_columns)
from epidemicmodeling_torch.data.oxford import load_oxford_data  # noqa: E402


def best_of_three(fn) -> float:
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def probe(path: Path) -> None:
    ref = pd.read_csv(path, low_memory=False)
    cols = read_csv_columns(path)
    cells = by_float = by_port = 0
    for name in ref.columns:
        if ref[name].dtype.kind != "f":
            continue
        want = ref[name].to_numpy(float)
        raw = cols[name]
        py = np.array([float(v) if v else np.nan for v in raw])
        got = parse_floats(raw, name)
        same = lambda a: (a == want) | (np.isnan(a) & np.isnan(want))
        cells += len(raw)
        by_float += int((~same(py)).sum())
        by_port += int((~same(got)).sum())
    port_s = best_of_three(lambda: load_oxford_data(path))
    pandas_s = best_of_three(lambda: jax_load(path))
    print(f"{path.name}: {len(ref)} rows, {cells} float cells; float() "
          f"differs from pandas on {by_float}, csvio on {by_port}; "
          f"load_oxford_data port {port_s:.3f} s, pandas {pandas_s:.3f} s "
          "(CPU)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regions", type=int, default=235)
    ap.add_argument("--days", type=int, default=532)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        frames = {
            "realistic_4x200.csv": realistic_oxford_frame(
                n_regions=4, n_days=200, seed=7)[0],
            f"synthetic_{args.regions}x{args.days}.csv":
                synthetic_oxford_frame(n_regions=args.regions,
                                       n_days=args.days, seed=0)[0],
        }
        for name, df in frames.items():
            df.to_csv(Path(tmp) / name, index=False)
            probe(Path(tmp) / name)


if __name__ == "__main__":
    main()
