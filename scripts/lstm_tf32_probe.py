#!/usr/bin/env python3
"""Do the LSTM's card-against-CPU checks see cuDNN's TF32?

    python3 scripts/lstm_tf32_probe.py

Run it from the root of a checkout on a machine with one CUDA card. The
port holds cuDNN's float32 recurrences in IEEE float32
(ml/lstm.ieee_float32_rnn); PyTorch lets them use TF32 matmuls by default.
This script runs the LSTM checks of chip_smoke.py and of
tests/test_torch_cuda.py::test_lstm_on_the_card_matches_the_cpu twice, once
as the port runs them and once with ieee_float32_rnn swapped for a context
that asks cuDNN for TF32, and prints each check's reading (<= 1 passes)
beside the raw differences:

- the univariate forecaster's first 20 epochs (hidden 100, T = 189) from the
  same weights on the card and on the CPU: chip_smoke.rms_loss_ratio, and
  the largest relative difference of the losses (over all 20, over the
  first 5, and of the first, a forward of the initial weights); the
  forward of the 250-epoch model with the same weights on the card and on
  the CPU at LSTM_FWD_TOL;
- the deep test04 stack's forward (hidden 200, 200, 100, 50, 20; 235 x 440
  x 37), weights trained on the card in IEEE float32, with and without the
  exp head: the reading at chip_smoke.LSTM_FWD_TOL and the largest absolute
  difference;
- chip_smoke.small_lstm_parity (hidden (32, 16), 4 x 60 x 5, 10 epochs,
  each head), as the smoke and the card test run it: the losses' reading
  at LSTM_LOSS_RTOL and the forward's at LSTM_FWD_TOL.

The last line of standard output holds every reading as one JSON object.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from epidemicmodeling_torch.data import synthetic_regions  # noqa: E402
from epidemicmodeling_torch.ml import LSTMForecaster, train_forecaster  # noqa: E402,E501
from epidemicmodeling_torch.ml import lstm as L  # noqa: E402

IEEE = L.ieee_float32_rnn


@contextlib.contextmanager
def tf32_rnn():
    """cuDNN's float32 recurrences with TF32 matmuls."""
    rnn = torch.backends.cudnn.rnn
    old = rnn.fp32_precision
    rnn.fp32_precision = "tf32"
    try:
        yield
    finally:
        rnn.fp32_precision = old


def loss_readings(l_card, l_cpu) -> dict:
    a, b = np.asarray(l_card), np.asarray(l_cpu)
    rel = np.abs(a - b) / b
    return dict(rms_loss_ratio=S.rms_loss_ratio(a, b),
                loss_max_rel=float(rel.max()), loss_first_rel=float(rel[0]),
                loss_max_rel_5=float(rel[:5].max()),
                loss_last=float(b[-1]))


def forward_readings(model, params, head, hidden, X) -> dict:
    cpu = LSTMForecaster(hidden, output_layer=head)
    cpu.load_params({k: v.cpu() for k, v in params.items()}, device="cpu")
    with torch.no_grad():
        out = model(X)
        ref = cpu(X.cpu())
    return dict(fwd_ratio=S.close_ratio(out, ref, S.LSTM_FWD_TOL),
                fwd_max_abs=float((out.cpu() - ref).abs().max()),
                fwd_scale=float(ref.abs().max()))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe needs one card")
    device = torch.device("cuda", 0)
    card = S.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"cudnn.rnn.fp32_precision default "
          f"{torch.backends.cudnn.rnn.fp32_precision!r}", flush=True)

    _, xs, _, _ = S.lstm_series()
    x_in, y_out = xs[:-1], xs[1:]
    uni = LSTMForecaster((100,))
    uni_p, _ = train_forecaster(uni, x_in, y_out,
                                torch.Generator().manual_seed(0),
                                num_epochs=S.LSTM_EPOCHS, lr=0.005,
                                lr_drop_period=125)
    truth = synthetic_regions(S.R_REGIONS, S.T_HIST, seed=0)
    U = [tr["u"] for tr in truth.values()]
    alpha = np.stack([tr["alpha"] for tr in truth.values()])
    X, targets = S.deep_features(device, U, alpha)
    deep = {head: S.train_deep(device, X, y, head)[:2]
            for head, y in targets.items()}
    rng = np.random.default_rng(2)
    xt, yt = (torch.as_tensor(rng.standard_normal((4, 60, n)), device=device)
              for n in (5, 1))

    out = {"card": card, "torch": torch.__version__}
    for mode, ctx in (("ieee", IEEE), ("tf32", tf32_rnn),
                      ("ieee_again", IEEE)):
        L.ieee_float32_rnn = ctx
        try:
            r = {"univariate": loss_readings(*S.lstm_parity(x_in, y_out,
                                                              device)[:2]),
                 "univariate_fwd": forward_readings(uni, uni_p, None, (100,),
                                                    xs)}
            for head, (model, params) in deep.items():
                r[f"deep_{head}"] = forward_readings(model, params, head,
                                                     S.DEEP_HIDDEN, X)
            for head in (None, "exp", "scaled_tanh"):
                loss, fwd = S.small_lstm_parity(device, xt, yt, head)[2:]
                r[f"small_{head}"] = dict(loss_ratio=loss, fwd_ratio=fwd)
        finally:
            L.ieee_float32_rnn = IEEE
        out[mode] = r
        for name, v in r.items():
            print(f"{mode:10s} {name:22s} " + " ".join(
                f"{k} {x:.3e}" for k, x in v.items()), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
