"""LSTM sequence forecasters: the ML experiment stack.

Counterpart of epidemicmodeling_tpu/ml/lstm.py (SURVEY.md §2.6):
- test00ReadOxfordDataPlusProcessLSTM.m:99-115: per-region univariate LSTM
  (sequenceInput -> lstmLayer(100) -> FC -> regression), adam, gradient
  clipping at 1, piecewise learning rate (x0.2 at epoch 125 of 250),
  standardized series, closed-loop rollout via predictAndUpdateState.
- test02FitExponentialLSTM.m:236-252: LSTM regression of the growth rate
  lambda from NPI features.
- test04FullFeatureExtMLpipeline.m:457-495: a deep stack of up to 5 LSTM
  layers with optional custom exp / scaled-tanh output layers.
- test05DirectNewCasesLearning.m:216-233: a direct multivariate LSTM on new
  cases + NPI features with closed-loop rollout.

Each layer is a ``torch.nn.LSTM`` (cuDNN on the card; the JAX package runs
this recurrence as XLA code, a scan over flax's OptimizedLSTMCell, not as a
Pallas kernel). flax's cell has the same gates in the same order (i, f, g,
o; c' = f c + i g, h' = o tanh c') but ONE bias per gate, on the recurrent
side; torch's second bias ``bias_ih`` is held at zero, outside the
optimizer and the clip norm, so training follows optax's. The model
computes in float32 whatever the input's dtype, as the flax model does.

Weights are a ``state_dict``; ``lstm_params_from_flax`` carries a flax
parameter tree across. The port's own initial weights follow flax's
distributions (lecun-normal input and head kernels, an orthogonal matrix
per recurrent gate block, zero biases, normal(1) / ones for the output
layers' alpha), drawn on the CPU from a ``torch.Generator``; they cannot
equal ``jax.random``'s.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.math import as_device_tensor
from .layers import ExpLayer, ScaledTanhLayer
from .optim import AdamState, adam_update, clip_by_global_norm

GATES = "ifgo"
# the standard deviation of N(0, 1) truncated to [-2, 2] (flax's
# variance_scaling divides by it so the truncated draws have variance
# 1 / fan_in)
TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def ieee_float32_rnn():
    """Run cuDNN's float32 recurrences in IEEE float32: PyTorch lets them
    use TF32 matmuls by default (torch.backends.cudnn.rnn.fp32_precision
    "tf32", 10-bit mantissas), and the flax model computes in float32.
    The backward pass reads the flag too, so training holds it across the
    whole step."""
    rnn = torch.backends.cudnn.rnn
    old = rnn.fp32_precision
    rnn.fp32_precision = "ieee"
    try:
        yield
    finally:
        rnn.fp32_precision = old


def _lecun_normal(fan_in: int, fan_out: int, generator) -> torch.Tensor:
    """flax's lecun_normal kernel (fan_in, fan_out): a normal truncated at
    two standard deviations, of variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(fan_in, fan_out), 0.0, std,
                                 -2.0 * std, 2.0 * std, generator=generator)


class LSTMForecaster(nn.Module):
    """Stacked-LSTM sequence regressor.

    hidden_sizes: e.g. (100,) for the univariate forecaster or
    (200, 200, 100, 50, 20) for the deep test04 stack.
    out_features: regression output dim (1 for case/lambda forecasting).
    output_layer: None | "exp" | "scaled_tanh" (the custom layers).

    Like the flax module, it takes its input width from the first input
    (``init``) or from the weights it is given (``load_params``).
    """

    def __init__(self, hidden_sizes: Sequence[int] = (100,),
                 out_features: int = 1, output_layer: Optional[str] = None):
        super().__init__()
        if output_layer not in (None, "exp", "scaled_tanh"):
            raise ValueError(f"unknown output_layer {output_layer!r}")
        self.hidden_sizes = tuple(hidden_sizes)
        self.out_features = out_features
        self.output_layer = output_layer
        self.in_features = None
        self.lstms = nn.ModuleList()
        self.head = None
        self.out_layer = None

    def _build(self, in_features: int, device) -> None:
        sizes = (in_features,) + self.hidden_sizes
        self.lstms = nn.ModuleList(
            nn.LSTM(n_in, n_h, batch_first=True, device=device)
            for n_in, n_h in zip(sizes[:-1], sizes[1:]))
        for lstm in self.lstms:
            lstm.bias_ih_l0.requires_grad_(False)
        self.head = nn.Linear(sizes[-1], self.out_features, device=device)
        if self.output_layer == "exp":
            self.out_layer = ExpLayer(self.out_features, device=device)
        elif self.output_layer == "scaled_tanh":
            self.out_layer = ScaledTanhLayer(self.out_features, device=device)
        self.in_features = in_features

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def init(self, generator: Optional[torch.Generator], x,
             device=None) -> dict:
        """Build the layers for ``x``'s width on ``device`` (else where
        ``x`` lies when it is a tensor, else on the CUDA card), draw
        flax-distributed initial weights from ``generator`` (seed 0 when
        None) and return them (a copy of the state_dict)."""
        dev = resolve_device(device, x)
        self._build(int(x.shape[-1]), dev)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = {}
        sizes = (self.in_features,) + self.hidden_sizes
        for li, (n_in, n_h) in enumerate(zip(sizes[:-1], sizes[1:])):
            w_ih, w_hh = [], []
            for _ in GATES:
                w_ih.append(_lecun_normal(n_in, n_h, generator).T)
                w_hh.append(nn.init.orthogonal_(torch.empty(n_h, n_h),
                                                generator=generator).T)
            params[f"lstms.{li}.weight_ih_l0"] = torch.cat(w_ih)
            params[f"lstms.{li}.weight_hh_l0"] = torch.cat(w_hh)
            params[f"lstms.{li}.bias_ih_l0"] = torch.zeros(4 * n_h)
            params[f"lstms.{li}.bias_hh_l0"] = torch.zeros(4 * n_h)
        params["head.weight"] = _lecun_normal(
            sizes[-1], self.out_features, generator).T
        params["head.bias"] = torch.zeros(self.out_features)
        if self.output_layer == "exp":
            params["out_layer.alpha"] = torch.randn(self.out_features,
                                                    generator=generator)
        elif self.output_layer == "scaled_tanh":
            params["out_layer.alpha"] = torch.ones(self.out_features)
        self.load_state_dict(params)
        return self.params()

    def params(self) -> dict:
        """A copy of the current weights (the state_dict)."""
        return {k: v.detach().clone() for k, v in self.state_dict().items()}

    def load_params(self, params: dict, device=None) -> None:
        """Load ``params`` (a state_dict, e.g. from lstm_params_from_flax)
        and move the model to ``device`` when given; a model not built for
        their input width is built on ``device``, else on the CUDA card."""
        in_features = int(params["lstms.0.weight_ih_l0"].shape[1])
        if self.in_features != in_features:
            self._build(in_features, resolve_device(device))
        elif device is not None:
            self.to(device)
        self.load_state_dict(params)

    def forward(self, x):
        """x: (T, F) single sequence or (B, T, F). Returns (.., T, out),
        float32."""
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        h = x.to(device=self.device, dtype=torch.float32)
        with ieee_float32_rnn():
            for lstm in self.lstms:
                h, _ = lstm(h)
        y = self.head(h)
        if self.out_layer is not None:
            y = self.out_layer(y)
        return y[0] if squeeze else y


def lstm_params_from_flax(tree) -> dict:
    """The port's state_dict of a flax LSTMForecaster's parameter tree
    (``{"params": {...}}`` or its inner dict, NumPy or JAX arrays):
    cell ``OptimizedLSTMCell_l``'s per-gate input kernels ``i{g}`` (in, h)
    and recurrent kernels ``h{g}`` (h, h) with their biases become
    ``weight_ih`` / ``weight_hh`` (4h, .) in gate order i, f, g, o and
    ``bias_hh``, with ``bias_ih`` zero; ``Dense_0`` the head, and
    ``ExpLayer_0`` / ``ScaledTanhLayer_0``'s alpha the output layer's.
    float32 CPU tensors."""
    tree = tree.get("params", tree)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    params = {}
    n_layers = sum(k.startswith("OptimizedLSTMCell_") for k in tree)
    for li in range(n_layers):
        cell = tree[f"OptimizedLSTMCell_{li}"]
        params[f"lstms.{li}.weight_ih_l0"] = torch.cat(
            [f32(cell[f"i{g}"]["kernel"]).T for g in GATES])
        params[f"lstms.{li}.weight_hh_l0"] = torch.cat(
            [f32(cell[f"h{g}"]["kernel"]).T for g in GATES])
        params[f"lstms.{li}.bias_hh_l0"] = torch.cat(
            [f32(cell[f"h{g}"]["bias"]) for g in GATES])
        params[f"lstms.{li}.bias_ih_l0"] = torch.zeros_like(
            params[f"lstms.{li}.bias_hh_l0"])
    params["head.weight"] = f32(tree["Dense_0"]["kernel"]).T
    params["head.bias"] = f32(tree["Dense_0"]["bias"])
    for name in ("ExpLayer_0", "ScaledTanhLayer_0"):
        if name in tree:
            params["out_layer.alpha"] = f32(tree[name]["alpha"])
    return params


def train_forecaster(model: LSTMForecaster, x, y,
                     generator: Optional[torch.Generator] = None,
                     num_epochs: int = 250, lr: float = 0.005,
                     lr_drop_period: int = 125, lr_drop_factor: float = 0.2,
                     grad_clip: float = 1.0, params: Optional[dict] = None,
                     device=None):
    """Train with adam + gradient clipping + piecewise learning rate (the
    reference's trainingOptions, test00:106-115), optax's update
    (ml/optim.py): clip_by_global_norm(grad_clip), then adam with lr until
    update lr_drop_period and lr_drop_factor * lr from there. x: (T, F) or
    (B, T, F); y matching (T, out) / (B, T, out). Starts from ``params``
    when given, else from ``model.init(generator, x)``. Runs on ``device``,
    else where ``x`` lies when it is a tensor, else on the CUDA card.
    Returns (params, losses): the trained state_dict and the loss before
    each update (floats)."""
    dev = resolve_device(device, x)
    x = as_device_tensor(x, dev)
    y = as_device_tensor(y, dev)
    if params is None:
        model.init(generator, x, dev)
    else:
        model.load_params(params, dev)
    trainable = [p for p in model.parameters() if p.requires_grad]
    state = AdamState(trainable)
    losses = []
    for epoch in range(num_epochs):
        with ieee_float32_rnn():
            loss = torch.mean((model(x) - y) ** 2)
            grads = torch.autograd.grad(loss, trainable)
        grads = clip_by_global_norm(grads, grad_clip)
        # optax.piecewise_constant_schedule(lr, {lr_drop_period: factor})
        # at update count `epoch`
        adam_update(trainable, grads, state,
                    lr_drop_factor * lr if epoch >= lr_drop_period else lr)
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().tolist() if losses else []
    return model.params(), losses


@torch.no_grad()
def _closed_loop(model, params, buf, T, n, col):
    """Rerun the whole (T + n)-row buffer n times on the buffer's device,
    writing output T + t - 1 into row T + t's column ``col``; ``params``
    (or, without them, the model) are moved there first."""
    if params is not None:
        model.load_params(params, buf.device)
    else:
        model.to(buf.device)
    preds = []
    for t in range(n):
        yt = model(buf)[T + t - 1, 0]
        preds.append(yt)
        buf[T + t, col] = yt
    return torch.stack(preds)


def _rollout_device(model, device, history) -> torch.device:
    """``device`` when given, else where a built model lies, else where
    ``history`` lies when it is a tensor, else the CUDA card."""
    if device is None and model.in_features is not None:
        device = model.device
    return resolve_device(device, history)


def rollout_forecast(model: LSTMForecaster, params, history, n_ahead: int,
                     device=None):
    """Closed-loop autoregressive rollout (predictAndUpdateState semantics,
    test00:118-128): feed the history, then repeatedly feed back the
    prediction. history: (T, 1) standardized series. Returns (n_ahead,).

    A fixed (T + n_ahead, 1) buffer, the whole buffer rerun each step and
    output T + t - 1 taken, as in the JAX package (the LSTM is causal, so
    the rows not yet written cannot reach it). Runs on ``device``, else
    where a built model lies, else where ``history`` lies when it is a
    tensor, else on the CUDA card."""
    history = as_device_tensor(history,
                               _rollout_device(model, device, history))
    buf = torch.cat([history, history.new_zeros(
        (n_ahead,) + tuple(history.shape[1:]))])
    return _closed_loop(model, params, buf, history.shape[0], n_ahead, 0)


def rollout_forecast_exog(model: LSTMForecaster, params, history,
                          future_exog, target_col: int = 0, device=None):
    """Closed-loop MULTIVARIATE rollout (predictAndUpdateState semantics of
    testScripts/test05DirectNewCasesLearning.m:216-233): the target channel
    is fed back autoregressively while the exogenous feature columns (the
    NPI schedule) follow the given future plan.

    history: (T, F) feature sequence seen so far; future_exog: (H, F)
    future feature rows whose target column is overwritten by the
    feedback. Returns (H,) predictions of the target channel. Runs where
    rollout_forecast does."""
    history = as_device_tensor(history,
                               _rollout_device(model, device, history))
    future = as_device_tensor(future_exog, history.device, history.dtype)
    buf = torch.cat([history, future])
    return _closed_loop(model, params, buf, history.shape[0],
                        future.shape[0], target_col)
