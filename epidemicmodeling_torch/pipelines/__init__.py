from .config import PipelineConfig
from .core import (
    RegionInit,
    TrainedRegionParams,
    ScenarioResult,
    train_regions,
    forecast_scenarios,
    pareto_prescribe,
    monte_carlo_baseline,
    scenario_from_schedule,
)
from .train_predict_prescribe import (run_pipeline, train_predict_prescribe,
                                      build_batches_from_frames,
                                      TrainPredictPrescribeResult)
from .checkpoint import (trained_params_from_numpy, region_init_from_numpy,
                         save_trained_params, load_trained_params,
                         save_trained_params_mat, load_trained_params_mat,
                         save_trained_params_dcp, load_trained_params_dcp)
from .forecast_quality import forecast_quality_assessment, BacktestResult
from . import forecast_quality, prescribe, train
from .prescribe import prescribe_from_checkpoint
from .train import train_npi_prescriptor

__all__ = [
    "PipelineConfig",
    "RegionInit",
    "TrainedRegionParams",
    "ScenarioResult",
    "train_regions",
    "forecast_scenarios",
    "pareto_prescribe",
    "monte_carlo_baseline",
    "scenario_from_schedule",
    "run_pipeline",
    "train_predict_prescribe",
    "build_batches_from_frames",
    "TrainPredictPrescribeResult",
    "trained_params_from_numpy",
    "region_init_from_numpy",
    "save_trained_params",
    "load_trained_params",
    "save_trained_params_mat",
    "load_trained_params_mat",
    "save_trained_params_dcp",
    "load_trained_params_dcp",
    "forecast_quality_assessment",
    "BacktestResult",
    "prescribe_from_checkpoint",
    "train_npi_prescriptor",
]
