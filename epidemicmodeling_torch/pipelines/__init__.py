from .config import PipelineConfig
from .core import (
    RegionInit,
    TrainedRegionParams,
    ScenarioResult,
    train_regions,
    forecast_scenarios,
    pareto_prescribe,
    monte_carlo_baseline,
)
from .train_predict_prescribe import (run_pipeline,
                                      TrainPredictPrescribeResult)
from .checkpoint import trained_params_from_numpy, region_init_from_numpy

__all__ = [
    "PipelineConfig",
    "RegionInit",
    "TrainedRegionParams",
    "ScenarioResult",
    "train_regions",
    "forecast_scenarios",
    "pareto_prescribe",
    "monte_carlo_baseline",
    "run_pipeline",
    "TrainPredictPrescribeResult",
    "trained_params_from_numpy",
    "region_init_from_numpy",
]
