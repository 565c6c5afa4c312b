"""The example drivers: the port's counterparts of the scripts in examples/
(the reference's testScripts surface), one module each.

Each runs as ``python -m epidemicmodeling_torch.examples.<name>`` with the
arguments of its namesake in examples/, on the CUDA card unless
``--device cpu`` is given, and each ``main`` takes ``device=`` the same
way, prints the lines its namesake prints and returns the numbers behind
them as a dict. Where the namesake takes a ``jax.random`` key, the driver
draws from a CPU ``torch.Generator`` seeded with the key's seed (so the
card and the CPU draw the same numbers) or takes the draws as arguments.

xprize_prescribe           train, predict and prescribe on OxCGRT CSVs
                           (ekf3 and ekf6 kernels on the card)
prescribe_from_checkpoint  train once, checkpoint, reload, sweep 2000 eps
forecast_quality           the paper's look-ahead backtest (ekf3)
realistic_data_pipeline    the product on artefact-laden CSVs (ekf3, ekf6)
spatial_sims               diffusion, walking sources, the agent sim
                           (stencil and pairwise kernels)
make_figures               the reference's headline figures (matplotlib)
seirp_scenarios            the SEIRP scenario study
rt_comparison              the four Rt estimators side by side
lstm_forecast              the 100-unit univariate LSTM forecaster
direct_newcases_lstm       the multivariate closed-loop LSTM
ml_comparison              ridge, ARX, SVR and LSTM on the growth rate
"""

NAMES = ("xprize_prescribe", "prescribe_from_checkpoint", "forecast_quality",
         "realistic_data_pipeline", "spatial_sims", "make_figures",
         "seirp_scenarios", "rt_comparison", "lstm_forecast",
         "direct_newcases_lstm", "ml_comparison")
