"""Readings that a cell's limits are set from (benchmark/limits/<cell>.json).

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 [--control]

On the card, at the cell's own sizes. Without --control: for each seed, a
run of the cell with a window of one request an input set (the benchmark's
own set-up, request and check), its compared numbers. With --control: for
each seed, the same input set and the same check, with the reference
computed in the precision below the configuration's (float32 with every
product's operands rounded to TF32) in the program's place. Prints one
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import entries, run


def control_numbers(files, seed, device) -> dict:
    """The control's numbers on the input set that a run of ``seed``
    checks."""
    traffic = files["traffic"]
    set_rngs, pick_rng = run.seeds(seed, traffic["input_sets"])
    k = int(pick_rng.integers(traffic["input_sets"]))
    entry = entries.load(traffic["entry"])(
        files["config"], traffic.get("request", {}), device, None)
    return entry.control(entry.make_set(set_rngs[k]), log=run.log)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 3
    device = torch.device("cuda", 0)
    root = Path.cwd()
    files = run.cell_files(root, args.workload)
    workdir = root / "build" / "benchmark" / args.workload
    workdir.mkdir(parents=True, exist_ok=True)
    for s in (int(x) for x in args.seeds.split(",")):
        if args.control:
            numbers = control_numbers(files, s, device)
        else:
            res = run.run_cell(files, s, 0.0, 0, device, workdir)
            numbers = res["numbers"]
        print(json.dumps({"workload": args.workload, "seed": s,
                          "control": args.control, "numbers": numbers}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
