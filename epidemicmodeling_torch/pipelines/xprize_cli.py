"""XPRIZE entry point as a command line, on the CUDA card.

Counterpart of epidemicmodeling_tpu/pipelines/xprize_cli.py:29-230, the
rebuild of testScripts/testPrescribeXPRIZE02.m (the Phase-II XPRIZE script:
dates, the 12 Oxford NPIs with codebook maxima (:24-38), a log+linear
epsilon grid (:49-53) and per-geo cost weights (:56-58), then the full
TrainPredictPrescribeNPI pipeline (:71)). It writes the XPRIZE prescriptions
schema (PrescriptionIndex, CountryName, RegionName, Date, <NPI columns>),
optionally the predictions schema and a JSON summary.

Usage:
    python -m epidemicmodeling_torch.pipelines.xprize_cli \\
        --data oxford.csv --geos countries_regions.csv \\
        --populations populations.csv \\
        --start-train 2020-03-01 --end-train 2021-01-01 \\
        --end-predict 2021-03-31 \\
        --costs uniform_random_costs.csv \\
        --prescriptions-out presc.csv --predictions-out pred.csv

It runs on the CUDA card (the hand-written kernels) unless ``--device cpu``
is given (their plain versions). ``--mesh auto|DPxEP`` splits the EKS
kernels' lanes over a mesh of slots: every card, or ``--cpu-devices N``
slots of the device (N CPU slots, which implies ``--device cpu`` when no
``--device`` is given; N slots a card with ``--device cuda``). The
summary also records the wall time of reading the CSVs, of the pipeline
and of writing the CSVs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX CLI's options, with --device."""
    ap = argparse.ArgumentParser(
        prog="epidemicmodeling_torch.pipelines.xprize_cli",
        description="Train-predict-prescribe NPI pipeline (XPRIZE entry point) "
                    "on a CUDA card")
    ap.add_argument("--data", required=True,
                    help="OxCGRT CSV (cases, deaths, NPI columns)")
    ap.add_argument("--geos", required=True,
                    help="countries_regions.csv listing GeoIDs to process")
    ap.add_argument("--populations", required=True,
                    help="populations.csv")
    ap.add_argument("--costs", default=None,
                    help="NPI cost-weight CSV (per-geo rows); default: "
                         "equal weights")
    ap.add_argument("--start-train", required=True)
    ap.add_argument("--end-train", required=True)
    ap.add_argument("--start-regression", default=None,
                    help="default: --start-train")
    ap.add_argument("--end-predict", required=True)
    ap.add_argument("--num-epsilon", type=int, default=250,
                    help="epsilon grid size (testPrescribeXPRIZE02.m:49)")
    ap.add_argument("--num-prescriptions", type=int, default=10,
                    help="PrescriptionIndex blocks written (evenly spaced "
                         "over the epsilon sweep)")
    ap.add_argument("--prescriptions-out", default="prescriptions.csv")
    ap.add_argument("--predictions-out", default=None,
                    help="optional predictions CSV (fixed-NPI scenario)")
    ap.add_argument("--trained-params-out", default=None,
                    help="optional checkpoint of trained coefficients "
                         "(.mat: the reference's cell table, else .npz)")
    ap.add_argument("--load-params", default=None,
                    help=".npz or .mat checkpoint to prescribe from WITHOUT "
                         "retraining (testPrescribeXPRIZE01.m flow)")
    ap.add_argument("--future-ip", default=None,
                    help="future intervention plan CSV (future_ip.csv "
                         "schema); predictions are conditioned on it "
                         "instead of the frozen-last-NPI scenario")
    ap.add_argument("--summary-out", default=None,
                    help="optional JSON summary (costs, front sizes, walls)")
    ap.add_argument("--backend", default="pallas",
                    choices=["vmap", "lanes", "pallas"],
                    help="compute backend: lanes and pallas both run the "
                         "batch-last path (the CUDA kernels on a card); "
                         "vmap runs the generic EKF/EKS core (tensor ops, "
                         "the MATLAB-exact pinv smoother gain)")
    ap.add_argument("--pareto-chunk", type=int, default=32)
    ap.add_argument("--observation-type", default="NEWCASES",
                    choices=["NEWCASES", "TOTALCASES"],
                    help="EKF observation model (SIAlphaModelEKF.m:51-58)")
    ap.add_argument("--num-monte-carlo", type=int, default=500,
                    help="random-NPI baseline rollouts per region "
                         "(TrainPredictPrescribeNPI.m:497)")
    ap.add_argument("--stochastic-forecast", action="store_true",
                    help="inject process noise into the forecast rollouts "
                         "(SIalpha_Controlled.m noise terms; default: "
                         "deterministic)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="N mesh slots a device: N CPU slots (implies "
                         "--device cpu unless --device is given; runs "
                         "--mesh without a card), or with --device cuda N "
                         "slots on each card, which share it in turn")
    ap.add_argument("--mesh", default=None,
                    help="split the EKS kernels' lanes over a device mesh: "
                         "'auto' uses every slot (dp x ep factorization), "
                         "or 'DPxEP' explicitly, e.g. '4x2'. Default: one "
                         "device")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator behind the Monte-Carlo "
                         "schedules and the stochastic forecasts")
    ap.add_argument("--float64", action="store_true",
                    help="run in float64 (CPU parity mode)")
    return ap


def main(argv=None) -> int:
    """Run the full train-predict-prescribe pipeline; writes the XPRIZE
    prescriptions/predictions CSVs and returns a process exit code."""
    args = build_arg_parser().parse_args(argv)
    from ..control import epsilon_grid
    from ..data import NPI_MAXES_DEFAULT, OXFORD_NPI_COLUMNS
    from ..data.oxford import load_geo_list, load_npi_costs
    from ..data.xprize_io import (read_future_ip, write_predictions_csv,
                                  write_prescriptions_csv)
    from ..parallel.mesh import Mesh, make_mesh
    from ..utils.dates import date_range_days
    from ..utils.device import resolve_device
    from .checkpoint import load_checkpoint, save_checkpoint
    from .config import PipelineConfig
    from .core import check_config, region_init, scenario_from_schedule
    from .train_predict_prescribe import train_predict_prescribe

    if args.cpu_devices and args.device is None:
        args.device = "cpu"
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        cards = ([torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
                 if device.type == "cuda" else [device])
        slots = [d for d in cards for _ in range(args.cpu_devices or 1)]
        if args.mesh == "auto":
            mesh = make_mesh(devices=slots)
        else:
            dp, ep = (int(v) for v in args.mesh.lower().split("x"))
            if dp * ep > len(slots):
                raise SystemExit(f"--mesh {args.mesh} needs {dp * ep} "
                                 f"devices, found {len(slots)}")
            grid = np.empty(dp * ep, dtype=object)
            grid[:] = slots[:dp * ep]
            mesh = Mesh(grid.reshape(dp, ep), ("dp", "ep"))
        device = mesh.lead
        print(f"mesh: {mesh.shape} over {mesh.size} devices", file=sys.stderr)
    cfg = PipelineConfig(backend=args.backend, pareto_chunk=args.pareto_chunk,
                         observation_type=args.observation_type,
                         num_monte_carlo=args.num_monte_carlo,
                         stochastic_forecast=args.stochastic_forecast)
    check_config(cfg)
    dtype = torch.float64 if args.float64 else torch.float32
    generator = torch.Generator(device).manual_seed(args.seed)
    P = len(OXFORD_NPI_COLUMNS)

    t0 = time.perf_counter()
    geo_ids = load_geo_list(args.geos)
    npi_weights = (load_npi_costs(args.costs, geo_ids) if args.costs
                   else np.ones(P))
    trained = None
    if args.load_params:
        trained = load_checkpoint(args.load_params)
        print(f"loaded trained parameters for {len(trained.names)} geos "
              f"from {args.load_params}")
    read_s = time.perf_counter() - t0

    eps = epsilon_grid(args.num_epsilon).numpy()
    res = train_predict_prescribe(
        npi_weights=npi_weights,
        epsilon_values=eps,
        start_train_date=args.start_train,
        end_train_date=args.end_train,
        start_regression_date=args.start_regression or args.start_train,
        end_predict_date=args.end_predict,
        data_file=args.data,
        geo_file=args.geos,
        populations_file=args.populations,
        npi_mins=np.zeros(P),
        npi_maxes=NPI_MAXES_DEFAULT,
        cfg=cfg,
        generator=generator,
        dtype=dtype,
        trained=trained,
        device=device,
        mesh=mesh,
    )
    stages = {k: v for k, v in res.stage_seconds.items() if k != "read_csv"}
    walls = {"read_csv": read_s + res.stage_seconds["read_csv"],
             "run_pipeline": sum(stages.values())}
    t0 = time.perf_counter()
    if args.trained_params_out:
        save_checkpoint(args.trained_params_out, res.trained)
    walls["write_params"] = time.perf_counter() - t0

    names = list(res.trained.names)
    E = res.pareto["J0"].shape[0]
    n_presc = min(args.num_prescriptions, E)
    sel = np.unique(np.linspace(0, E - 1, n_presc).round().astype(int))
    u = res.pareto["u_prescribed"][torch.as_tensor(sel, device=device)]
    H = u.shape[2]
    # prescriptions start the day after training ends
    presc_start = date_range_days(args.end_train, 2)[1]

    sc = res.scenarios["fixed"]
    T_hist = sc.s.shape[1] - H
    if args.predictions_out and args.future_ip:
        t0 = time.perf_counter()
        u_plan = read_future_ip(args.future_ip, names, presc_start,
                                date_range_days(presc_start, H)[-1])
        u_plan = np.minimum(u_plan, NPI_MAXES_DEFAULT)
        init = region_init(res.batch_train, cfg, dtype, device)
        walls["read_csv"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        sc = scenario_from_schedule(
            res.batch_full, res.trained, init, res.s_hist, u_plan,
            npi_weights, np.zeros(P), NPI_MAXES_DEFAULT, T_hist, cfg,
            generator=generator, dtype=dtype, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls["future_ip_scenario"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    write_prescriptions_csv(args.prescriptions_out, names, presc_start, u)
    print(f"wrote {args.prescriptions_out}: {len(sel)} prescription indices "
          f"x {len(names)} geos x {H} days")
    if args.predictions_out:
        pop = torch.as_tensor(np.asarray(res.trained.population, float),
                              dtype=sc.s.dtype, device=sc.s.device)[:, None]
        cases = sc.s * sc.i * sc.alpha * pop            # (R, T_full)
        write_predictions_csv(args.predictions_out, names, presc_start,
                              cases[:, T_hist:])
        print(f"wrote {args.predictions_out}"
              + (" (conditioned on future-IP plan)" if args.future_ip
                 else ""))
    walls["write_csv"] = time.perf_counter() - t0
    print("wall: " + " ".join(f"{k}={v:.3f}s" for k, v in walls.items())
          + "; run_pipeline: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in stages.items()),
          file=sys.stderr)

    if args.summary_out:
        summary = {
            "geos": names,
            "epsilon": [float(e) for e in eps],
            "prescription_epsilon_indices": [int(i) for i in sel],
            "J0_mean_per_eps": res.pareto["J0"].mean(1).tolist(),
            "J1_mean_per_eps": res.pareto["J1"].mean(1).tolist(),
            "pareto_front_sizes": res.pareto_front.sum(0).tolist(),
            "wall_seconds": walls,
        }
        with open(args.summary_out, "w") as f:
            json.dump(summary, f)
        print(f"wrote {args.summary_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
