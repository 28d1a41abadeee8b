"""GRU in torch gate order (r, z, n).

Counterpart of fastenhancer_tpu/nn/gru.py. The input half x W_ih^T + b_ih
is one matmul over the whole sequence; a Python loop runs the recurrence:

    r = sigmoid(x_r + h W_hr^T + b_hr)
    z = sigmoid(x_z + h W_hz^T + b_hz)
    n = tanh(x_n + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
"""
from __future__ import annotations

import typing as tp

import torch

from .layers import maybe_wn_weight, uniform_init

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def init_gru(generator: torch.Generator, input_size: int, hidden_size: int,
             device: torch.device) -> Params:
    """torch nn.GRU init: every weight and bias ~ U(+-1/sqrt(hidden))."""
    b = 1.0 / hidden_size ** 0.5
    return {
        "weight_ih": uniform_init(generator, (3 * hidden_size, input_size), b,
                                  device),
        "weight_hh": uniform_init(generator, (3 * hidden_size, hidden_size), b,
                                  device),
        "bias_ih": uniform_init(generator, (3 * hidden_size,), b, device),
        "bias_hh": uniform_init(generator, (3 * hidden_size,), b, device),
    }


def _weights(params: Params) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    return (maybe_wn_weight(params, "weight_ih"),
            maybe_wn_weight(params, "weight_hh"),
            params["bias_ih"], params["bias_hh"])


def gru_cell(x_proj: Tensor, h: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """One recurrence step from a precomputed input projection.
    x_proj: [N, 3H] = x W_ih^T + b_ih; h: [N, H] -> h' [N, H]."""
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru(params: Params, x: Tensor, h0: tp.Optional[Tensor] = None
        ) -> tp.Tuple[Tensor, Tensor]:
    """Full-sequence GRU. x: [T, N, I] -> (y [T, N, H], h_T [N, H])."""
    w_ih, w_hh, b_ih, b_hh = _weights(params)
    t, n, _ = x.shape
    h = h0 if h0 is not None else x.new_zeros(n, w_hh.shape[1])
    x_proj = x @ w_ih.T + b_ih  # [T, N, 3H]
    ys = []
    for i in range(t):
        h = gru_cell(x_proj[i], h, w_hh, b_hh)
        ys.append(h)
    return torch.stack(ys), h


def gru_step(params: Params, x: Tensor, h: Tensor) -> Tensor:
    """Single streaming step. x: [N, I], h: [N, H] -> h' [N, H]."""
    w_ih, w_hh, b_ih, b_hh = _weights(params)
    return gru_cell(x @ w_ih.T + b_ih, h, w_hh, b_hh)
