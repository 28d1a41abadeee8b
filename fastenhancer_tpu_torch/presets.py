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
* `LN_B`: the ln ablation at FE_B's widths (`fastenhancer.ln`;
  configs/ablation/ln_b.yaml's model_kwargs).
* `TIME_KERNEL_B`: the time_kernel ablation at FE_B's widths
  (`fastenhancer.time_kernel`; configs/ablation/time_kernel_b.yaml's
  model_kwargs).
* `NONCAUSAL_HUGE`: the offline noncausal FastEnhancer of the DNS recipes
  (`fastenhancer.noncausal`; configs/fastenhancer_dns/huge_noncausal.yaml's
  model_kwargs: C=128, 6 blocks, F'=64, hop 100).
* `BSRNN_S`: the BSRNN baseline at C=64, 6 layers, 3.54M parameters
  (`bsrnn`; configs/others/bsrnn_s.yaml's model_kwargs).
* `FSPEN`: the FSPEN baseline (`fspen`; configs/others/fspen.yaml's
  model_kwargs, which configs/others_dns/fspen.yaml shares).
* `LISENNET`: the LiSenNet baseline (`lisennet`;
  configs/others/lisennet.yaml's model_kwargs, which
  configs/others_dns/lisennet.yaml shares).
* `FE_T_SHARD`: FastEnhancer_T's shard training recipe
  (configs/fastenhancer_shard/t.yaml): its model, model_kwargs, wrapper,
  the mixer and dereverberation of `data`, the sampling rate, batch
  duration and valid segment, and the whole `train` and `valid` sections,
  as the training wrapper reads them.

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

LN_B: tp.Dict[str, tp.Any] = dict(
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
    activation_kwargs={"inplace": True},
    input_compression=0.3, normalize_final_conv=True, weight_norm=True,
    resnet=False, final_scale=True, final_scale_init="one",
)

TIME_KERNEL_B: tp.Dict[str, tp.Any] = dict(
    channels=48,
    stride=4,
    rnnformer_kwargs=dict(
        num_blocks=3, channels=36, freq=24, num_heads=4, eps=1.0e-5,
        positional_embedding="train", attn_bias=False, post_act=False,
        pre_norm=False,
    ),
    pre_post_init="linear_fixed",
    n_fft=512, hop_size=256, win_size=512, window="hann",
    stft_normalized=False, mask=None, activation="SiLU",
    activation_kwargs={"inplace": True},
    input_compression=0.3, normalize_final_conv=True, weight_norm=True,
    final_scale=True, kernel_size_freq=[8, 3, 3], kernel_size_time=3,
)

NONCAUSAL_HUGE: tp.Dict[str, tp.Any] = dict(
    channels=128,
    kernel_size=[8, 3, 3, 3, 3, 3],
    stride=4,
    rnnformer_kwargs=dict(
        num_blocks=6, channels=128, freq=64, num_heads=4, eps=1.0e-5,
        positional_embedding="train", attn_bias=False, post_act=False,
        pre_norm=False, p_dropout=0.0,
    ),
    pre_post_init="linear_fixed",
    n_fft=512, hop_size=100, win_size=512, window="hann",
    stft_normalized=False, mask=None, activation="SiLU",
    activation_kwargs={"inplace": True},
    input_compression=0.3, normalize_final_conv=True, weight_norm=True,
    resnet=False,
)

BSRNN_S: tp.Dict[str, tp.Any] = dict(
    num_channels=64, num_layers=6, bias=True, affine=True, n_fft=512,
    hop_size=256, win_size=512, input_compression=0.3, window="hann",
)

FSPEN: tp.Dict[str, tp.Any] = dict(
    channels=[4, 16, 32],
    kernel_size=[6, 8, 6],
    stride=[2, 2, 2],
    dpe_kwargs=dict(num_blocks=3, channels=16, freq=32, groups=8,
                    norm="LayerNorm-FreqChannels"),
    n_fft=512, hop_size=256, win_size=512, input_compression=0.3,
    window="hann",
)

LISENNET: tp.Dict[str, tp.Any] = dict(
    num_channels=16, n_blocks=2, n_fft=512, hop_size=256, win_size=512,
    input_compression=0.3,
)

FE_T_SHARD: tp.Dict[str, tp.Any] = dict(
    model="fastenhancer.default",
    model_kwargs=dict(
        channels=24,
        kernel_size=[8, 3, 3],
        stride=4,
        rnnformer_kwargs=dict(
            num_blocks=2, channels=20, freq=16, num_heads=4, eps=1.0e-5,
            positional_embedding="train", attn_bias=False, post_act=False,
            pre_norm=False,
        ),
        pre_post_init="linear_fixed",
        n_fft=512, hop_size=256, win_size=512, window="hann",
        stft_normalized=False, mask=None, activation="SiLU",
        activation_kwargs={"inplace": True},
        input_compression=0.3, normalize_final_conv=True, weight_norm=True,
        resnet=False,
    ),
    wrapper="ns_shard",
    data=dict(
        train=dict(mixer=dict(
            speech_dbFS=[-35.0, -15.0], snr=[0.0, 20.0],
            seg_rel_threshold=-25.0, seg_abs_threshold=None)),
        valid=dict(segment_size=32000),
        sampling_rate=16000,
        max_duration=128,
        dereverberation=dict(rir_target_type="rts", early_rir_sec=0.05,
                             t60_max=0.15),
    ),
    train=dict(
        test=False, save_interval=10, max_epochs=200, steps_per_epoch=1000,
        fp16=True, clip_grad=None, seed=1, plot_param_and_grad=False,
        losses=dict(
            mag_mse=dict(weight=0.3),
            complex_mse=dict(weight=0.2),
            consistency=dict(weight=0.3, compression=0.3),
            wav_l1=dict(weight=0.2),
        ),
        optimizer="AdamP",
        optimizer_kwargs=dict(lr=0.002, weight_decay=0.01, wd_ratio=1.0,
                              betas=[0.95, 0.999]),
        optimizer_groups=[
            dict(regex_list=[r"rnn\.\d\.rnn.+parametrizations.+original0$",
                             r"enc_pre\.2\.weight",
                             r"(en|de)coder\.\d\.2\.weight",
                             r"rnn_(pre|post)\.1\.weight",
                             r"dec_post\.scale"],
                 weight_decay=0, projection="disabled"),
            dict(regex_list=[r"rnn_pre\.0.+parametrizations.+original1$",
                             r"rnn\.\d\..+parametrizations.+original1$",
                             r"enc_pre\.0\.weight",
                             r"(en|de)coder\.\d\.0\.weight",
                             r"rnn_(pre|post)\.2\.weight"],
                 projection="channelwise"),
            dict(regex_list=[r"dec_post\.weight"], projection="layerwise"),
            dict(regex_list=[r"rnn_post\.0.+parametrizations.+original1$"],
                 projection=1),
        ],
        scheduler="CosineAnnealingWarmup",
        scheduler_kwargs=dict(warmup_iterations=500, eta_min=1.0e-6,
                              warn=False),
    ),
    valid=dict(batch_size=64, num_workers=2),
)

__all__ = ["FE_B", "DPT_B", "DPRNN_B", "LN_B", "TIME_KERNEL_B",
           "NONCAUSAL_HUGE", "BSRNN_S", "FSPEN", "LISENNET", "FE_T_SHARD"]
