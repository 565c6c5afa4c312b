from .plots import (plot_state_estimates, plot_scenarios, plot_pareto_cloud,
                    plot_backtest_curves, plot_training_diagnostic,
                    plot_npi_schedule, select_optimal_index)
from .animation import animate_field, animate_agents

__all__ = ["plot_state_estimates", "plot_scenarios", "plot_pareto_cloud",
           "plot_backtest_curves", "plot_training_diagnostic",
           "plot_npi_schedule", "select_optimal_index",
           "animate_field", "animate_agents"]
