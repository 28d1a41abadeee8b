"""FastEnhancer's dprnn ablation, inference and streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/dprnn.py. The default
block's frequency MHSA becomes a bidirectional frequency GRU (dual-path
RNN): each block is a causal time GRU followed by a bidirectional GRU
across the F' bins (hidden C_frnn per direction), both with post-BN
residuals (reference: models/fastenhancer/dprnn/model.py:132-246). The
frequency filterbank uses the absolute-Hz grid with linear or mel init
(:251-313). The streaming carry is the time GRU's hidden state only; the
frequency GRU runs within one frame.

Three streaming forms:
* `streaming_step` (inherited): each block's carry [B*F', C], rows
  batch-major, as the JAX package's XLA path;
* `streaming_chunk` (inherited), C frames a step on the same carry;
* `streaming_step_fused`, on folded variables: the whole block stack is one
  CUDA kernel per frame (ops/dprnn_stack.py) over stacked frequency-major
  carries [NB, F', B, C]; it takes one frame a step (stream raises
  ValueError with a plan and chunk_frames > 1, as the JAX package does).

Outside the fused stack the time GRU is one gru_scan launch per block, as
in the default model's eval forward. `forward(train=True, row_mask=...)`
trains it: train-mode BN over the batch and the time GRU and the frequency
biGRU as nn.gru's and nn.bigru's differentiable loops (JAX dprnn.py:
132-174).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ... import nn as fnn
from ...functional import init_istft_carry, init_stft_carry
from ...ops.dprnn_stack import dprnn_stack_step, plan_dprnn_stack
from ...ops.gru_scan import gru_fused
from .default import (Model as DefaultModel, Params, Tensor, fold_fc_bn,
                      fold_prenorm_into_rnn)
from .dptransformer import set_ablation_filterbanks


@dataclasses.dataclass
class DPRNNConfig:
    num_blocks: int = 3
    channels: int = 32
    channels_frnn: int = 16
    freq: int = 32
    eps: float = 1e-5
    pre_norm: bool = False


class Model(DefaultModel):
    """FastEnhancer dprnn. Takes the reference's `model_kwargs` unchanged
    (configs/ablation/dprnn_*.yaml)."""

    def __init__(
        self,
        channels: int = 64,
        kernel_size: tp.Sequence[int] = (8, 3, 3),
        stride: int = 4,
        dprnn_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        activation: str = "ReLU",
        activation_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        n_fft: int = 512,
        hop_size: int = 160,
        win_size: int = 400,
        window: tp.Optional[str] = "povey",
        stft_normalized: bool = False,
        mask: tp.Optional[str] = None,
        input_compression: float = 0.25,
        weight_norm: bool = False,
        final_scale: tp.Union[bool, str] = "exp",
        normalize_final_conv: bool = False,
        pre_post_init: tp.Optional[str] = None,
        sampling_rate: int = 16_000,
        stft_method: str = "fft",
    ):
        dp = DPRNNConfig(**(dprnn_kwargs or {}))
        super().__init__(
            channels=channels, kernel_size=kernel_size, stride=stride,
            rnnformer_kwargs=dict(
                num_blocks=dp.num_blocks, channels=dp.channels, freq=dp.freq,
                eps=dp.eps, pre_norm=dp.pre_norm, positional_embedding=None),
            activation=activation, activation_kwargs=activation_kwargs,
            n_fft=n_fft, hop_size=hop_size, win_size=win_size, window=window,
            stft_normalized=stft_normalized, mask=mask,
            input_compression=input_compression, weight_norm=weight_norm,
            normalize_final_conv=normalize_final_conv,
            pre_post_init=pre_post_init, sampling_rate=sampling_rate,
            stft_method=stft_method)
        if final_scale not in (True, False, "exp"):
            raise ValueError(f"final_scale must be True, False or 'exp', not "
                             f"{final_scale!r}")
        self.dp = dp
        self.final_scale = final_scale

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """The default model's tree with dprnn blocks and, with a
        pre_post_init, the dprnn's own fixed filterbanks (mel, or the
        absolute-Hz linear grid)."""
        dev = torch.device(device)
        variables = super().init(generator, dev)
        if self.pre_post_init is not None:
            set_ablation_filterbanks(variables["params"], self.freq,
                                     self.dp.freq, self.pre_post_init,
                                     self.sampling_rate, dev)
        return variables

    def _block_init(self, g: torch.Generator, i: int,
                    dev: torch.device) -> tp.Tuple[Params, Params]:
        """One dprnn block: time GRU + bidirectional frequency GRU, each
        with its fc and post-BN residual."""
        dp = self.dp
        trnn = fnn.init_gru(g, dp.channels, dp.channels, dev)
        frnn = fnn.init_bigru(g, dp.channels, dp.channels_frnn, dev)
        if self.weight_norm:
            for rnn in (trnn, frnn["fwd"], frnn["bwd"]):
                rnn["weight_ih"] = fnn.to_wn(rnn["weight_ih"])
                rnn["weight_hh"] = fnn.to_wn(rnn["weight_hh"])
        bn_t_p, bn_t_s = fnn.init_batch_norm(dp.channels, dev)
        bn_f_p, bn_f_s = fnn.init_batch_norm(dp.channels, dev)
        bp: Params = {
            "trnn": trnn,
            "trnn_fc": fnn.torch_linear_init(g, dp.channels, dp.channels,
                                             False, dev),
            "trnn_post_norm": bn_t_p,
            "frnn": frnn,
            "frnn_fc": fnn.torch_linear_init(g, dp.channels,
                                             2 * dp.channels_frnn, False, dev),
            "frnn_post_norm": bn_f_p,
        }
        bs: Params = {"trnn_post_norm": bn_t_s, "frnn_post_norm": bn_f_s}
        if dp.pre_norm:
            for which in ("trnn", "frnn"):
                _, bs[f"{which}_pre_norm"] = fnn.init_batch_norm(
                    dp.channels, dev, affine=False)
        return bp, bs

    # -- block: time GRU + bidirectional frequency GRU -------------------------

    def _block_apply(self, p: Params, s: Params, x: Tensor,
                     h0: tp.Optional[Tensor], train: bool = False,
                     bw: tp.Optional[Tensor] = None
                     ) -> tp.Tuple[Tensor, Tensor, tp.Optional[Params]]:
        """x: [T, B, F', C] -> (x, h_T [B*F', C], the new statistics in
        train mode, else None) (reference: models/fastenhancer/dprnn/
        model.py:227-246). In eval the time GRU is one gru_scan launch; in
        train nn.gru's loop, the BNs in train mode weighted by `bw`."""
        dp = self.dp
        t, b, f, c = x.shape
        new_s = dict(s) if train and s else None

        def bn(bn_p: tp.Optional[Params], key: str, y: Tensor) -> Tensor:
            y, st = fnn.batch_norm(bn_p, s[key], y, train=train, eps=dp.eps,
                                   weight=bw)
            if new_s is not None:
                new_s[key] = st
            return y

        # --- time GRU ---
        y = x
        if s and "trnn_pre_norm" in s:
            y = bn(None, "trnn_pre_norm", y)
        if h0 is None:
            h0 = x.new_zeros(b * f, c)
        gru = fnn.gru if train else gru_fused
        y, h_t = gru(p["trnn"], y.reshape(t, b * f, c), h0)
        y = fnn.linear(p["trnn_fc"], y.reshape(t, b, f, c))
        if p.get("trnn_post_norm") is not None:
            y = bn(p["trnn_post_norm"], "trnn_post_norm", y)
        x = y + x
        # --- bidirectional frequency GRU, over the bins ---
        y = x
        if s and "frnn_pre_norm" in s:
            y = bn(None, "frnn_pre_norm", y)
        y = fnn.bigru(p["frnn"], y.reshape(t * b, f, c).transpose(0, 1))
        y = y.transpose(0, 1).reshape(t, b, f, 2 * dp.channels_frnn)
        y = fnn.linear(p["frnn_fc"], y)
        if p.get("frnn_post_norm") is not None:
            y = bn(p["frnn_post_norm"], "frnn_post_norm", y)
        return y + x, h_t, new_s

    # -- fused-stack streaming (CUDA kernel) -------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """fused=False: the default carry (a list of [B*F', C], rows
        batch-major). fused=True: the kernel's stacked frequency-major
        carries [NB, F', B, C]."""
        if not fused:
            return super().init_streaming_carry(batch, dtype, device)
        dp = self.dp
        return {"stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
                "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
                "h": torch.zeros(dp.num_blocks, dp.freq, batch, dp.channels,
                                 dtype=dtype, device=device)}

    def build_stack_plan(self, variables: Params,
                         dtype: tp.Optional[torch.dtype] = None) -> Params:
        """Pack FOLDED rf_blocks params for the dprnn-stack kernel
        (ops/dprnn_stack.py): post-BNs merged into the fcs, pre-norms into
        the GRU input weights."""
        if any(variables["stats"]["rf_blocks"]):
            raise ValueError("build_stack_plan expects fold() output")
        return plan_dprnn_stack(variables["params"]["rf_blocks"], dtype=dtype)

    def model_forward_fused(self, variables: Params, plan: Params,
                            spec: Tensor, h: Tensor
                            ) -> tp.Tuple[Tensor, Tensor]:
        """model_forward for one frame, inference, with the block stack as
        one kernel launch. spec: compressed [B, F, 1, 2]; h: stacked
        frequency-major [NB, F', B, C] carries -> (mask, h_t)."""
        params, stats = variables["params"], variables["stats"]
        x, x_res, skips, b, t = self._encode(params, stats, spec)
        y, h_t = dprnn_stack_step(plan, x[0].transpose(0, 1).contiguous(), h)
        mask = self._decode(params, stats, y.transpose(0, 1)[None], x_res,
                            skips, b, t, spec.shape[1])
        return mask, h_t

    def streaming_step_fused(self, variables: Params, plan: Params,
                             carry: Params, wav_hop: Tensor
                             ) -> tp.Tuple[Params, Tensor]:
        """streaming_step with the block stack as one kernel per frame; same
        math as streaming_step on folded variables. The carry is
        init_streaming_carry(fused=True)'s."""
        spec, stft_c = self._stream_front(carry, wav_hop)
        mask, h_t = self.model_forward_fused(variables, plan, spec,
                                             carry["h"])
        return self._stream_back(spec, mask, carry, stft_c, h_t)

    # -- deploy-time folding -----------------------------------------------------

    # -- the reference's parameter names (optimizer groups) -------------------

    tname_prepost = "dprnn"
    tname_block = "dprnn_block"

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """dprnn_block.{i}.{trnn,frnn}... with torch's *_l0 and
        *_l0_reverse GRU names; the rest as the default's under the
        dprnn prefixes."""
        if path[0] == "rf_blocks" and path[2] in ("trnn", "frnn"):
            prefix = f"{self.tname_block}.{path[1]}.{path[2]}"
            if path[2] == "trnn":
                suffix, leaf, sub = "_l0", path[3], path[4:5]
            else:
                suffix = "_l0" if path[3] == "fwd" else "_l0_reverse"
                leaf, sub = path[4], path[5:6]
            if leaf.startswith("weight") and sub:
                which = "original0" if sub[0] == "g" else "original1"
                return f"{prefix}.parametrizations.{leaf}{suffix}.{which}"
            return f"{prefix}.{leaf}{suffix}"
        return super().torch_name(path)

    def _block_fold(self, bp: Params, bs: Params) -> Params:
        """Fold one block: strip weight norm, post-BN into each fc,
        pre-norms into the GRU input weights."""
        eps = self.dp.eps

        def plain(rnn: Params) -> Params:
            return {k: (fnn.maybe_wn_weight(rnn, k) if k.startswith("weight")
                        else rnn[k])
                    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}

        nb: Params = {
            "trnn": plain(bp["trnn"]),
            "frnn": {d: plain(bp["frnn"][d]) for d in ("fwd", "bwd")},
            "trnn_fc": fold_fc_bn(bp["trnn_fc"], bp["trnn_post_norm"],
                                  bs["trnn_post_norm"], eps),
            "frnn_fc": fold_fc_bn(bp["frnn_fc"], bp["frnn_post_norm"],
                                  bs["frnn_post_norm"], eps),
            "trnn_post_norm": None,
            "frnn_post_norm": None,
        }
        if self.dp.pre_norm:
            nb["trnn"] = fold_prenorm_into_rnn(nb["trnn"], bs["trnn_pre_norm"],
                                               eps)
            nb["frnn"] = {d: fold_prenorm_into_rnn(nb["frnn"][d],
                                                   bs["frnn_pre_norm"], eps)
                          for d in ("fwd", "bwd")}
        return nb
