from .layers import (
    linear,
    conv1d_cl,
    conv_transpose1d_cl,
    batch_norm,
    init_batch_norm,
    layer_norm_fc,
    init_layer_norm,
    wn_weight,
    to_wn,
    maybe_wn_weight,
    get_activation,
    torch_linear_init,
    torch_conv1d_init,
    torch_convtranspose1d_init,
    uniform_init,
)
from .gru import init_gru, gru, gru_step, gru_cell, init_bigru, bigru
from .lstm import init_lstm, init_bilstm, lstm_cell, lstm, bilstm
from .attention import init_attention, attention

__all__ = [
    "linear", "conv1d_cl", "conv_transpose1d_cl", "batch_norm",
    "init_batch_norm", "layer_norm_fc", "init_layer_norm", "wn_weight",
    "to_wn", "maybe_wn_weight",
    "get_activation", "torch_linear_init", "torch_conv1d_init",
    "torch_convtranspose1d_init", "uniform_init",
    "init_gru", "gru", "gru_step", "gru_cell", "init_bigru", "bigru",
    "init_lstm", "init_bilstm", "lstm_cell", "lstm", "bilstm",
    "init_attention", "attention",
]
