"""LSTM in torch gate order (i, f, g, o).

Counterpart of fastenhancer_tpu/nn/lstm.py. The input half x W_ih^T + b_ih
is one matmul over the whole sequence; a Python loop runs the recurrence:

    i, f, g, o = split(x_proj + h W_hh^T + b_hh)
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')
"""
from __future__ import annotations

import typing as tp

import torch

from .layers import uniform_init

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def init_lstm(generator: torch.Generator, input_size: int, hidden_size: int,
              device: torch.device) -> Params:
    """torch nn.LSTM init: every weight and bias ~ U(+-1/sqrt(hidden))."""
    b = 1.0 / hidden_size ** 0.5
    return {
        "weight_ih": uniform_init(generator, (4 * hidden_size, input_size), b,
                                  device),
        "weight_hh": uniform_init(generator, (4 * hidden_size, hidden_size), b,
                                  device),
        "bias_ih": uniform_init(generator, (4 * hidden_size,), b, device),
        "bias_hh": uniform_init(generator, (4 * hidden_size,), b, device),
    }


def init_bilstm(generator: torch.Generator, input_size: int, hidden_size: int,
                device: torch.device) -> Params:
    """Bidirectional LSTM: {"fwd": lstm params, "bwd": lstm params} (torch
    weight_*_l0 / weight_*_l0_reverse)."""
    return {"fwd": init_lstm(generator, input_size, hidden_size, device),
            "bwd": init_lstm(generator, input_size, hidden_size, device)}


def _cell(gates: Tensor, c: Tensor) -> tp.Tuple[Tensor, Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell(x_proj: Tensor, h: Tensor, c: Tensor, w_hh: Tensor,
              b_hh: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """One recurrence step from a precomputed input projection.
    x_proj: [N, 4H] = x W_ih^T + b_ih; h, c: [N, H] -> (h', c')."""
    return _cell(x_proj + h @ w_hh.T + b_hh, c)


def lstm(params: Params, x: Tensor,
         hc0: tp.Optional[tp.Tuple[Tensor, Tensor]] = None
         ) -> tp.Tuple[Tensor, tp.Tuple[Tensor, Tensor]]:
    """Full-sequence LSTM. x: [T, N, I] -> (y [T, N, H], (h_T, c_T))."""
    t, n, _ = x.shape
    hidden = params["weight_hh"].shape[1]
    if hc0 is None:
        h = c = x.new_zeros(n, hidden)
    else:
        h, c = hc0
    x_proj = x @ params["weight_ih"].T + params["bias_ih"]  # [T, N, 4H]
    ys = []
    for i in range(t):
        h, c = lstm_cell(x_proj[i], h, c, params["weight_hh"],
                         params["bias_hh"])
        ys.append(h)
    return torch.stack(ys), (h, c)


def bilstm(params: Params, x: Tensor) -> Tensor:
    """Bidirectional full-sequence LSTM. x: [T, N, I] -> [T, N, 2H] (forward
    outputs concatenated with the reversed-scan backward outputs, torch
    bidirectional=True layout). Both directions run in one loop over
    direction-stacked rows, T steps rather than 2T, as the JAX function
    does."""
    fwd, bwd = params["fwd"], params["bwd"]
    t, n, _ = x.shape
    hidden = fwd["weight_hh"].shape[1]
    xx = torch.stack([x, x.flip(0)], dim=1)                    # [T, 2, N, I]
    w_ih = torch.stack([fwd["weight_ih"], bwd["weight_ih"]])
    w_hh = torch.stack([fwd["weight_hh"], bwd["weight_hh"]])
    b_ih = torch.stack([fwd["bias_ih"], bwd["bias_ih"]])
    b_hh = torch.stack([fwd["bias_hh"], bwd["bias_hh"]])
    x_proj = torch.einsum("tdni,dgi->tdng", xx, w_ih) + b_ih[:, None]
    h = c = x.new_zeros(2, n, hidden)
    ys = []
    for i in range(t):
        gates = x_proj[i] + torch.einsum("dnh,dgh->dng", h, w_hh) \
            + b_hh[:, None]
        h, c = _cell(gates, c)
        ys.append(h)
    ys = torch.stack(ys)                                       # [T, 2, N, H]
    return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1)
