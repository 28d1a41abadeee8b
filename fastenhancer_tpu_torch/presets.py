"""Model configurations the port ships with, as `model_kwargs` dicts.

Copies, so that the port and `chip_smoke.py` need neither the JAX package
nor a YAML reader (the card's machine has neither):

* `FE_B`: FastEnhancer_B, the flagship (`fastenhancer.default`;
  configs/fastenhancer/b.yaml's model_kwargs, as `__graft_entry__.py`'s
  FLAGSHIP_KWARGS holds them).
* `DPT_B`: the dptransformer ablation at FE_B's widths
  (`fastenhancer.dptransformer`; configs/ablation/dpt_b.yaml's
  model_kwargs).
* `DPRNN_B`: the dprnn ablation at FE_B's widths (`fastenhancer.dprnn`;
  configs/ablation/dprnn_b.yaml's model_kwargs).
* `BSRNN_S`: the BSRNN baseline at C=64, 6 layers, 3.54M parameters
  (`bsrnn`; configs/others/bsrnn_s.yaml's model_kwargs).

tests/test_torch_presets.py holds each against its source.
"""
from __future__ import annotations

import typing as tp

FE_B: tp.Dict[str, tp.Any] = dict(
    channels=48,
    kernel_size=[8, 3, 3],
    stride=4,
    rnnformer_kwargs=dict(
        num_blocks=3, channels=36, freq=24, num_heads=4, eps=1.0e-5,
        positional_embedding="train", attn_bias=False, post_act=False,
        pre_norm=False,
    ),
    pre_post_init="linear_fixed",
    n_fft=512, hop_size=256, win_size=512, window="hann",
    stft_normalized=False, mask=None, activation="SiLU",
    input_compression=0.3, normalize_final_conv=True, weight_norm=True,
    resnet=False,
)

DPT_B: tp.Dict[str, tp.Any] = dict(
    channels=48,
    kernel_size=[8, 3, 3],
    stride=4,
    pre_post_init="linear_fixed",
    n_fft=512, hop_size=256, win_size=512, window="hann",
    stft_normalized=False, mask=None, activation="SiLU",
    activation_kwargs={"inplace": True},
    input_compression=0.3, normalize_final_conv=True, weight_norm=True,
    final_scale=True, final_scale_init="one",
    dpt_kwargs=dict(
        num_blocks=3, channels=36, freq=24, num_heads=4, eps=1.0e-5,
        lookbehind=31, positional_embedding="train", attn_bias=False,
        post_act=False, pre_norm=False,
    ),
)

DPRNN_B: tp.Dict[str, tp.Any] = dict(
    channels=48,
    kernel_size=[8, 3, 3],
    stride=4,
    pre_post_init="linear_fixed",
    n_fft=512, hop_size=256, win_size=512, window="hann",
    stft_normalized=False, mask=None, activation="SiLU",
    activation_kwargs={"inplace": True},
    input_compression=0.3, normalize_final_conv=True, weight_norm=True,
    final_scale=True,
    dprnn_kwargs=dict(
        num_blocks=3, channels=36, channels_frnn=18, freq=24, eps=1.0e-5,
        pre_norm=False,
    ),
)

BSRNN_S: tp.Dict[str, tp.Any] = dict(
    num_channels=64, num_layers=6, bias=True, affine=True, n_fft=512,
    hop_size=256, win_size=512, input_compression=0.3, window="hann",
)

__all__ = ["FE_B", "DPT_B", "DPRNN_B", "BSRNN_S"]
