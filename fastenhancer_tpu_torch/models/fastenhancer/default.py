"""FastEnhancer (RNNFormer), inference and streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/default.py. One
parameter tree (nested dicts and lists of tensors, the JAX package's
{"params", "stats"} layout, so `utils/bridge.py` moves it across by path)
serves the offline `forward` and the per-hop `streaming_step`. `fold()`
strips weight norm and merges BatchNorm into the convs and fcs; folded and
unfolded trees run through the same code (a conv applies BN only if its
subtree has one).

`streaming_step_fused` runs the RNNFormer block stack as one CUDA kernel
(ops/rnnformer_stack.py) on folded variables: the serving and benchmark path
of FastEnhancer_B.

Not ported yet (each raises NotImplementedError): training-mode BatchNorm
and `forward(train=True)` with its remat and row_mask (ROADMAP queue 1
item 10), and chunked streaming (`stream(chunk_frames>1)`,
`streaming_chunk`; ROADMAP queue 1 item 4).

Architecture: complex spectrogram [B, F, T, 2] -> strided "reshape-trick"
conv encoder over frequency -> frequency resampling -> K RNNFormer blocks
(time GRU + frequency MHSA with post-BN residuals) -> skip-concat conv
decoder -> scaled transposed-conv upsample -> complex ratio mask.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ... import nn as fnn
from ...functional import (
    STFTConfig,
    compress,
    uncompress,
    compressed_stft,
    compressed_istft,
    stft_streaming_step,
    istft_streaming_step,
    init_stft_carry,
    init_istft_carry,
)
from ...ops.rnnformer_stack import plan_stack, rnnformer_stack_step

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

_TRAIN_TODO = ("training mode is not ported yet (ROADMAP queue 1 item 10: "
               "train-mode BatchNorm, remat, row_mask)")
_CHUNK_TODO = ("chunked streaming is not ported yet (ROADMAP queue 1 "
               "item 4: stream(chunk_frames>1), streaming_chunk)")


# ---------------------------------------------------------------------------
# numpy helpers (copies of the JAX module's :116-162 and :183-188)
# ---------------------------------------------------------------------------

def rf_pre_post_weights(n_freq: int, n_filter: int, init: str,
                        sr: int = 16_000) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Triangular filterbank weights [n_filter, n_freq] and its row-normalized
    inverse [n_freq, n_filter]. init in {linear, mel}[_fixed]."""
    if init.startswith("linear"):
        delta = np.full((n_filter - 1, 1), (n_freq - 1) / (n_filter - 1))
        f_filter = np.linspace(0, n_freq - 1, n_filter)
    elif init.startswith("mel"):
        def freq_idx_to_mel(f: float) -> float:
            hz = f / n_freq * sr / 2
            return 2595.0 * math.log10(1 + hz / 700)

        max_hz = sr / 2 * (n_freq - 1) / n_freq
        delta_hz = max_hz / (n_freq - 1)
        max_mel = freq_idx_to_mel(n_freq - 1)

        def mel_idx_to_freq_idx(n: float) -> float:
            mel = n / (n_filter - 1) * max_mel
            return 700.0 * (10 ** (mel / 2595) - 1) / delta_hz

        # low filters too narrow for one bin -> linear there, mel above
        f_filter: tp.List[float] = []
        f_cur = mel_idx_to_freq_idx(0)
        n_start = 0
        for n_start in range(0, n_filter - 1):
            f_next = mel_idx_to_freq_idx(n_start + 1)
            if f_next - f_cur >= 1 and n_start <= f_cur:
                break
            f_filter.append(float(n_start))
            f_cur = f_next
        f_filter.extend(mel_idx_to_freq_idx(n) for n in range(n_start, n_filter))
        f_filter = np.asarray(f_filter, dtype=np.float64)
        delta = (f_filter[1:] - f_filter[:-1])[:, None]
    else:
        raise ValueError(f"unsupported rf init: {init}")

    f_freqs = np.arange(n_freq, dtype=np.float64)
    down = (f_filter[1:, None] - f_freqs[None, :]) / delta
    up = (f_freqs[None, :] - f_filter[:-1, None]) / delta
    down = np.concatenate([down, np.ones((1, n_freq))], axis=0)
    up = np.concatenate([np.ones((1, n_freq)), up], axis=0)
    pre = np.maximum(0.0, np.minimum(down, up))
    pre = pre / pre.sum(axis=1, keepdims=True)
    post = pre.T.copy()
    post = post / post.sum(axis=1, keepdims=True)
    return pre.astype(np.float32), post.astype(np.float32)


def positional_embedding(channels: int, freq: int) -> np.ndarray:
    """Log-spaced sin/cos frequency embedding [F, C]."""
    f = np.arange(1, freq + 1, dtype=np.float64) * (math.pi / freq)
    c = np.exp(np.linspace(math.log(1.0), math.log(freq - 1), channels // 2))
    grid = f[:, None] * c[None, :]
    return np.concatenate([np.sin(grid), np.cos(grid)], axis=1).astype(
        np.float32)


def fold_fc_bn(fc: Params, bn_p: Params, bn_s: Params, eps: float) -> Params:
    """Post-norm BN folded into the preceding linear."""
    g = bn_p["weight"] / torch.sqrt(bn_s["var"] + eps)
    return {"weight": fc["weight"] * g[:, None],
            "bias": bn_p["bias"] - bn_s["mean"] * g}


def fold_prenorm_into_rnn(rnn: Params, bn_s: Params, eps: float) -> Params:
    """Affine-less pre-norm folded into the GRU input weights and bias."""
    std = torch.sqrt(bn_s["var"] + eps)
    beta = -bn_s["mean"] / std
    rnn = dict(rnn)
    rnn["bias_ih"] = rnn["bias_ih"] + rnn["weight_ih"] @ beta
    rnn["weight_ih"] = rnn["weight_ih"] / std
    return rnn


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RNNFormerConfig:
    num_blocks: int = 3
    channels: int = 32
    freq: int = 32
    num_heads: int = 4
    eps: float = 1e-8
    positional_embedding: tp.Optional[str] = "train"  # None | fixed | train
    attn_bias: bool = False
    post_act: bool = False
    pre_norm: bool = False
    p_dropout: float = 0.0


class Model(torch.nn.Module):
    """FastEnhancer default. Takes the reference's `model_kwargs` unchanged
    (configs/fastenhancer/*.yaml). The module holds the configuration only;
    weights live in the variables tree that `init` returns and every apply
    method takes."""

    def __init__(
        self,
        channels: int = 64,
        kernel_size: tp.Sequence[int] = (8, 3, 3),
        stride: int = 4,
        rnnformer_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        activation: str = "ReLU",
        activation_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        n_fft: int = 512,
        hop_size: int = 256,
        win_size: int = 512,
        window: tp.Optional[str] = "hann",
        stft_normalized: bool = False,
        mask: tp.Optional[str] = None,
        input_compression: float = 0.3,
        weight_norm: bool = False,
        normalize_final_conv: bool = False,
        pre_post_init: tp.Optional[str] = None,
        resnet: bool = False,
        sampling_rate: int = 16_000,
        stft_method: str = "fft",
    ):
        super().__init__()
        del activation_kwargs  # torch `inplace` flag: meaningless here
        if kernel_size[0] % stride or (kernel_size[0] - stride) % 2:
            raise ValueError(f"kernel_size[0]={kernel_size[0]} does not fit "
                             f"stride {stride}")
        self.channels = channels
        self.kernel_size = list(kernel_size)
        self.stride = stride
        self.rf = RNNFormerConfig(**(rnnformer_kwargs or {}))
        self.act = fnn.get_activation(activation)
        self.hop_size = hop_size
        self.stft_cfg = STFTConfig(
            n_fft=n_fft, hop_size=hop_size, win_size=win_size,
            win_type=window, normalized=stft_normalized, method=stft_method)
        self.mask_act = {None: lambda x: x, "sigmoid": torch.sigmoid,
                         "tanh": torch.tanh}[mask]
        self.input_compression = input_compression
        self.weight_norm = weight_norm
        self.normalize_final_conv = normalize_final_conv
        self.pre_post_init = pre_post_init
        self.resnet = resnet
        self.sampling_rate = sampling_rate
        self.freq = n_fft // 2 // stride  # encoder-out freq bins
        self.num_blocks = self.rf.num_blocks
        self.block_freq = self.rf.freq
        self.block_channels = self.rf.channels

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """Fresh {"params", "stats"} on `device`, with the JAX init's
        distributions and tree (torch-default uniform inits, identity
        BatchNorm, weight norm on the GRU and qkv weights). Values are drawn
        on the CPU from `generator`, so a seed gives the same weights on
        every device."""
        rf, c = self.rf, self.channels
        g, dev = generator, torch.device(device)
        params: Params = {}
        stats: Params = {}

        def conv_bn(out_ch: int, in_ch: int, k: int):
            bn_p, bn_s = fnn.init_batch_norm(out_ch, dev)
            return ({"conv": fnn.torch_conv1d_init(g, out_ch, in_ch, k, False,
                                                   dev), "bn": bn_p},
                    {"bn": bn_s})

        k0 = self.kernel_size[0]
        params["enc_pre"], stats["enc_pre"] = conv_bn(
            c, 2 * self.stride, k0 // self.stride)
        params["encoder"], stats["encoder"] = [], []
        for k in self.kernel_size[1:]:
            p, s = conv_bn(c, c, k)
            params["encoder"].append(p)
            stats["encoder"].append(s)

        if self.pre_post_init is None:
            pre_w = fnn.torch_linear_init(g, rf.freq, self.freq, False,
                                          dev)["weight"]
            post_w = fnn.torch_linear_init(g, self.freq, rf.freq, False,
                                           dev)["weight"]
        else:
            pre_w, post_w = (torch.from_numpy(w).to(dev)
                             for w in rf_pre_post_weights(
                                 self.freq, rf.freq, self.pre_post_init,
                                 self.sampling_rate))
        p, stats["rf_pre"] = conv_bn(self.block_channels, c, 1)
        params["rf_pre"] = {"lin": {"weight": pre_w}, **p}
        p, stats["rf_post"] = conv_bn(c, self.block_channels, 1)
        params["rf_post"] = {"lin": {"weight": post_w}, **p}

        params["rf_blocks"], stats["rf_blocks"] = [], []
        for i in range(self.num_blocks):
            bp, bs = self._block_init(g, i, dev)
            params["rf_blocks"].append(bp)
            stats["rf_blocks"].append(bs)

        params["decoder"], stats["decoder"] = [], []
        for k in self.kernel_size[:0:-1]:
            p1, s1 = conv_bn(c, 2 * c, 1)
            p2, s2 = conv_bn(c, c, k)
            params["decoder"].append({"conv1": p1["conv"], "conv2": p2["conv"],
                                      "bn1": p1["bn"], "bn2": p2["bn"]})
            stats["decoder"].append({"bn1": s1["bn"], "bn2": s2["bn"]})

        p1, s1 = conv_bn(c, 2 * c, 1)
        convt = fnn.torch_convtranspose1d_init(g, c, 2, k0, True, dev)
        convt["scale"] = torch.ones(1, device=dev)
        params["dec_post"] = {**p1, "convt": convt}
        stats["dec_post"] = s1
        return {"params": params, "stats": stats}

    def _block_init(self, g: torch.Generator, i: int,
                    dev: torch.device) -> tp.Tuple[Params, Params]:
        """One RNNFormer block: time GRU + frequency MHSA with post-BN
        residuals."""
        rf = self.rf
        ch = rf.channels
        rnn = fnn.init_gru(g, ch, ch, dev)
        attn = fnn.init_attention(g, ch, rf.attn_bias, dev)
        if self.weight_norm:
            rnn["weight_ih"] = fnn.to_wn(rnn["weight_ih"])
            rnn["weight_hh"] = fnn.to_wn(rnn["weight_hh"])
            attn["qkv"]["weight"] = fnn.to_wn(attn["qkv"]["weight"])
        bn_rnn_p, bn_rnn_s = fnn.init_batch_norm(ch, dev)
        bn_attn_p, bn_attn_s = fnn.init_batch_norm(ch, dev)
        bp: Params = {
            "rnn": rnn,
            "rnn_fc": fnn.torch_linear_init(g, ch, ch, False, dev),
            "rnn_post_norm": bn_rnn_p,
            "attn": attn,
            "attn_fc": fnn.torch_linear_init(g, ch, ch, False, dev),
            "attn_post_norm": bn_attn_p,
        }
        bs: Params = {"rnn_post_norm": bn_rnn_s, "attn_post_norm": bn_attn_s}
        if rf.pre_norm:
            _, bs["rnn_pre_norm"] = fnn.init_batch_norm(ch, dev, affine=False)
            _, bs["attn_pre_norm"] = fnn.init_batch_norm(ch, dev, affine=False)
        if i == 0 and rf.positional_embedding is not None:
            bp["pe"] = {"weight": torch.from_numpy(
                positional_embedding(ch, rf.freq)).to(dev)}
        return bp, bs

    # -- building blocks ------------------------------------------------------

    def _conv_bn_act(self, p: Params, s: tp.Optional[Params], x: Tensor, *,
                     stride: int = 1, padding: int = 0, act: bool = True,
                     eps: float = 1e-5) -> Tensor:
        """conv (+BN if the subtree has one) (+activation); x: [N, F, Cin]."""
        conv = dict(p["conv"])
        conv["weight"] = fnn.maybe_wn_weight(p["conv"], "weight")
        y = fnn.conv1d_cl(conv, x, stride=stride, padding=padding)
        if p.get("bn") is not None:
            y, _ = fnn.batch_norm(p["bn"], s["bn"], y, train=False, eps=eps)
        return self.act(y) if act else y

    def _scaled_convt(self, p: Params, x: Tensor) -> Tensor:
        """ScaledConvTranspose1d; an unfolded tree carries the scale."""
        w = p["weight"]
        if "scale" in p:
            if self.normalize_final_conv:
                norm = w.square().sum().sqrt()
                w = w / norm.clamp_min(1e-12) * p["scale"]
            else:
                w = w * p["scale"]
        pad = (self.kernel_size[0] - self.stride) // 2
        return fnn.conv_transpose1d_cl({"weight": w, "bias": p["bias"]}, x,
                                       stride=self.stride, padding=pad)

    def _strided_reshape(self, x: Tensor) -> Tensor:
        """[N, F, C] -> pad -> [N, F/s, C*s] (stride-major channel order)."""
        s = self.stride
        pad = (self.kernel_size[0] - s) // 2
        x = torch.nn.functional.pad(x, (0, 0, pad, pad))
        n, f, c = x.shape
        return x.reshape(n, f // s, s * c)

    # -- core network ---------------------------------------------------------

    def model_forward(self, params: Params, stats: Params, spec: Tensor,
                      h0: tp.Optional[tp.List[Tensor]] = None,
                      train: bool = False
                      ) -> tp.Tuple[Tensor, tp.List[Tensor], Params]:
        """Compressed spec [B, F, T, 2] -> (mask [B, F, T, 2], h_T list,
        stats)."""
        if train:
            raise NotImplementedError(_TRAIN_TODO)
        x, x_res, skips, b, t = self._encode(params, stats, spec)
        h_out: tp.List[Tensor] = []
        for i, (bp, bs) in enumerate(zip(params["rf_blocks"],
                                         stats["rf_blocks"])):
            x, h_t = self._block_apply(bp, bs, x, None if h0 is None else h0[i])
            h_out.append(h_t)
        mask = self._decode(params, stats, x, x_res, skips, b, t,
                            spec.shape[1])
        return mask, h_out, stats

    def _encode(self, params: Params, stats: Params, spec: Tensor
                ) -> tp.Tuple[Tensor, Tensor, tp.List[Tensor], int, int]:
        """Everything before the block stack: spec [B, F, T, 2] ->
        (x [T, B, F', C'], rf_pre residual, skips, b, t)."""
        b, f_in, t, _ = spec.shape
        x = spec.permute(0, 2, 1, 3).reshape(b * t, f_in, 2)
        x = self._strided_reshape(x)
        x = self._conv_bn_act(params["enc_pre"], stats["enc_pre"], x)
        skips = [x]
        for i, (p, st) in enumerate(zip(params["encoder"], stats["encoder"])):
            x_in = x
            k = self.kernel_size[1 + i]
            x = self._conv_bn_act(p, st, x, padding=(k - 1) // 2)
            skips.append(x)
            if self.resnet:
                x = x + x_in
        x_res = x
        x = torch.einsum("oF,nFc->noc", params["rf_pre"]["lin"]["weight"], x)
        x = self._conv_bn_act(params["rf_pre"], stats["rf_pre"], x, act=False)
        x = x.reshape(b, t, self.block_freq, x.shape[-1]).transpose(0, 1)
        return x, x_res, skips, b, t

    def _decode(self, params: Params, stats: Params, x: Tensor, x_res: Tensor,
                skips: tp.List[Tensor], b: int, t: int, f_in: int) -> Tensor:
        """Everything after the block stack: x [T, B, F', C'] -> mask
        [B, F, T, 2]."""
        x = x.transpose(0, 1).reshape(b * t, self.block_freq, x.shape[-1])
        x = torch.einsum("oF,nFc->noc", params["rf_post"]["lin"]["weight"], x)
        x = self._conv_bn_act(params["rf_post"], stats["rf_post"], x,
                              act=False)
        if self.resnet:
            x = x + x_res
        for i, (p, st) in enumerate(zip(params["decoder"], stats["decoder"])):
            x_in = x
            x = torch.cat([x, skips.pop()], dim=-1)
            unit1 = {"conv": p["conv1"], "bn": p.get("bn1")}
            unit2 = {"conv": p["conv2"], "bn": p.get("bn2")}
            y = self._conv_bn_act(unit1, {"bn": st.get("bn1")}, x)
            k = self.kernel_size[len(self.kernel_size) - 1 - i]
            x = self._conv_bn_act(unit2, {"bn": st.get("bn2")}, y,
                                  padding=(k - 1) // 2)
            if self.resnet:
                x = x + x_in
        x = torch.cat([x, skips.pop()], dim=-1)
        x = self._conv_bn_act(params["dec_post"], stats["dec_post"], x)
        x = self._scaled_convt(params["dec_post"]["convt"], x)  # [B*T, F, 2]
        mask = self.mask_act(x)
        return mask.reshape(b, t, f_in, 2).permute(0, 2, 1, 3)

    def _block_apply(self, p: Params, s: Params, x: Tensor,
                     h0: tp.Optional[Tensor]) -> tp.Tuple[Tensor, Tensor]:
        """x: [T, B, F', C] -> (x, h_T [B*F', C]); eval mode."""
        rf = self.rf
        t, b, f, c = x.shape
        # --- time GRU ---
        x_in = x
        y = x
        if s and "rnn_pre_norm" in s:
            y, _ = fnn.batch_norm(None, s["rnn_pre_norm"], y, train=False,
                                  eps=rf.eps)
        if h0 is None:
            h0 = x.new_zeros(b * f, c)
        y, h_t = fnn.gru(p["rnn"], y.reshape(t, b * f, c), h0)
        y = fnn.linear(p["rnn_fc"], y.reshape(t, b, f, c))
        if p.get("rnn_post_norm") is not None:
            y, _ = fnn.batch_norm(p["rnn_post_norm"], s["rnn_post_norm"], y,
                                  train=False, eps=rf.eps)
        if rf.post_act:
            y = self.act(y)
        x = y + x_in
        # --- positional embedding (block 0 only) ---
        if "pe" in p:
            x = x + p["pe"]["weight"]
        # --- frequency attention ---
        x_in = x
        y = x
        if s and "attn_pre_norm" in s:
            y, _ = fnn.batch_norm(None, s["attn_pre_norm"], y, train=False,
                                  eps=rf.eps)
        y = fnn.attention(p["attn"], y.reshape(t * b, f, c), rf.num_heads)
        y = fnn.linear(p["attn_fc"], y.reshape(t, b, f, c))
        if p.get("attn_post_norm") is not None:
            y, _ = fnn.batch_norm(p["attn_post_norm"], s["attn_post_norm"], y,
                                  train=False, eps=rf.eps)
        if rf.post_act:
            y = self.act(y)
        return y + x_in, h_t

    # -- offline graph (wav -> wav) --------------------------------------------

    @staticmethod
    def complex_mask_mul(spec: Tensor, mask: Tensor) -> Tensor:
        re = spec[..., 0] * mask[..., 0] - spec[..., 1] * mask[..., 1]
        im = spec[..., 0] * mask[..., 1] + spec[..., 1] * mask[..., 0]
        return torch.stack([re, im], dim=-1)

    def forward(self, variables: Params, wav: Tensor, train: bool = False
                ) -> tp.Tuple[Tensor, Tensor, Params]:
        """wav [B, T] -> (wav_hat [B, T], spec_hat compressed [B, F, T', 2],
        stats). Inference only."""
        if train:
            raise NotImplementedError(_TRAIN_TODO)
        params, stats = variables["params"], variables["stats"]
        spec = compressed_stft(wav, self.stft_cfg, self.input_compression,
                               discard_last_freq_bin=True)
        mask, _, stats = self.model_forward(params, stats, spec)
        spec_hat = self.complex_mask_mul(spec, mask)
        wav_hat = compressed_istft(spec_hat, self.stft_cfg,
                                   self.input_compression,
                                   discard_last_freq_bin=True,
                                   length=wav.shape[-1])
        return wav_hat, spec_hat, stats

    # -- streaming --------------------------------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """{"stft", "istft", "h"} rolling state for `batch` streams. h is a
        list of [B*F', C] block carries, or stacked [NB, B*F', C] with
        fused=True (the kernel's layout). Rows are batch-major."""
        h = [torch.zeros(batch * self.block_freq, self.block_channels,
                         dtype=dtype, device=device)
             for _ in range(self.num_blocks)]
        return {
            "stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
            "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
            "h": torch.stack(h) if fused else h,
        }

    def _stream_front(self, carry: Params, wav_hop: Tensor
                      ) -> tp.Tuple[Tensor, Tensor]:
        """STFT step + last-bin drop + compress -> (spec [B, F, 1, 2],
        new stft cache)."""
        spec, stft_c = stft_streaming_step(wav_hop, carry["stft"],
                                           self.stft_cfg)
        return (compress(spec[:, :-1, None, :], self.input_compression),
                stft_c)

    def _stream_back(self, spec: Tensor, mask: Tensor, carry: Params,
                     stft_c: Tensor, h_t) -> tp.Tuple[Params, Tensor]:
        """Mask multiply + uncompress + last-bin re-append + iSTFT step."""
        spec_hat = self.complex_mask_mul(spec, mask)
        spec_hat = uncompress(spec_hat, self.input_compression)[:, :, 0, :]
        spec_hat = torch.cat([spec_hat, torch.zeros_like(spec_hat[:, :1])],
                             dim=1)
        wav_out, istft_c = istft_streaming_step(spec_hat, carry["istft"],
                                                self.stft_cfg)
        return {"stft": stft_c, "istft": istft_c, "h": h_t}, wav_out

    def streaming_step(self, variables: Params, carry: Params,
                       wav_hop: Tensor) -> tp.Tuple[Params, Tensor]:
        """One hop: wav_hop [B, hop] -> (new_carry, wav_out [B, hop]); the
        output is delayed n_fft - hop samples."""
        spec, stft_c = self._stream_front(carry, wav_hop)
        mask, h_t, _ = self.model_forward(variables["params"],
                                          variables["stats"], spec,
                                          h0=carry["h"])
        return self._stream_back(spec, mask, carry, stft_c, h_t)

    def streaming_chunk(self, variables: Params, carry: Params,
                        wav_chunk: Tensor) -> tp.Tuple[Params, Tensor]:
        raise NotImplementedError(_CHUNK_TODO)

    # -- fused-stack streaming (CUDA kernel) -------------------------------------

    def build_stack_plan(self, variables: Params,
                         dtype: tp.Optional[torch.dtype] = None) -> Params:
        """Pack FOLDED rf_blocks params for the block-stack kernel
        (ops/rnnformer_stack.py). The kernel implements only the deploy-time
        block form (no BN, no pre-norms, post_act=False)."""
        if self.rf.post_act:
            raise NotImplementedError("fused stack: post_act recipes")
        if any(variables["stats"]["rf_blocks"]):
            raise ValueError("build_stack_plan expects fold() output")
        return plan_stack(variables["params"]["rf_blocks"], self.block_freq,
                          self.rf.num_heads, dtype=dtype)

    def model_forward_fused(self, variables: Params, plan: Params,
                            spec: Tensor, h: Tensor
                            ) -> tp.Tuple[Tensor, Tensor]:
        """model_forward for one frame, inference, with the block stack as
        one kernel launch. spec: compressed [B, F, 1, 2]; h: stacked
        [NB, B*F', C] carries -> (mask [B, F, 1, 2], h_t stacked)."""
        params, stats = variables["params"], variables["stats"]
        x, x_res, skips, b, t = self._encode(params, stats, spec)
        y, h_t = rnnformer_stack_step(plan, x[0].contiguous(), h,
                                      self.rf.num_heads)
        mask = self._decode(params, stats, y[None], x_res, skips, b, t,
                            spec.shape[1])
        return mask, h_t

    def streaming_step_fused(self, variables: Params, plan: Params,
                             carry: Params, wav_hop: Tensor
                             ) -> tp.Tuple[Params, Tensor]:
        """streaming_step with the block stack fused into one kernel; same
        math as streaming_step on folded variables."""
        spec, stft_c = self._stream_front(carry, wav_hop)
        h = carry["h"]
        if isinstance(h, (list, tuple)):
            h = torch.stack(h)
        mask, h_t = self.model_forward_fused(variables, plan, spec, h)
        return self._stream_back(spec, mask, carry, stft_c, h_t)

    def stream(self, variables: Params, wav: Tensor, chunk_frames: int = 1,
               fused_plan: tp.Optional[Params] = None) -> Tensor:
        """Whole-utterance streaming, one hop per step.
        wav [B, hop*T] -> [B, hop*T]; `fused_plan` (build_stack_plan() of
        folded variables) runs the block stack as one kernel per frame."""
        if chunk_frames != 1:
            raise NotImplementedError(_CHUNK_TODO)
        b, length = wav.shape
        hop = self.hop_size
        t = length // hop
        carry = self.init_streaming_carry(b, wav.dtype, wav.device,
                                          fused=fused_plan is not None)
        outs = []
        for i in range(t):
            x = wav[:, i * hop:(i + 1) * hop]
            if fused_plan is None:
                carry, y = self.streaming_step(variables, carry, x)
            else:
                carry, y = self.streaming_step_fused(variables, fused_plan,
                                                     carry, x)
            outs.append(y)
        return torch.cat(outs, dim=1) if outs else wav[:, :0]

    # -- deploy-time folding -----------------------------------------------------

    def fold(self, variables: Params) -> Params:
        """Strip weight norm, merge BN into convs and fcs, fold pre-norms.
        Returns folded {"params", "stats"} that the same apply code runs."""
        params, stats = variables["params"], variables["stats"]

        def merge_conv_bn(conv: Params, bn_p: Params, bn_s: Params,
                          eps: float = 1e-5) -> Params:
            w = fnn.maybe_wn_weight(conv, "weight")
            g = bn_p["weight"] / torch.sqrt(bn_s["var"] + eps)
            return {"weight": w * g.reshape(-1, *([1] * (w.ndim - 1))),
                    "bias": bn_p["bias"] - bn_s["mean"] * g}

        out: Params = {
            "enc_pre": {"conv": merge_conv_bn(params["enc_pre"]["conv"],
                                              params["enc_pre"]["bn"],
                                              stats["enc_pre"]["bn"])},
            "encoder": [{"conv": merge_conv_bn(p["conv"], p["bn"], s["bn"])}
                        for p, s in zip(params["encoder"], stats["encoder"])],
        }
        for name in ("rf_pre", "rf_post"):
            out[name] = {"lin": dict(params[name]["lin"]),
                         "conv": merge_conv_bn(params[name]["conv"],
                                               params[name]["bn"],
                                               stats[name]["bn"])}
        out["rf_blocks"] = [self._block_fold(bp, bs) for bp, bs in
                            zip(params["rf_blocks"], stats["rf_blocks"])]
        out["decoder"] = [
            {"conv1": merge_conv_bn(p["conv1"], p["bn1"], s["bn1"]),
             "conv2": merge_conv_bn(p["conv2"], p["bn2"], s["bn2"])}
            for p, s in zip(params["decoder"], stats["decoder"])]

        convt = params["dec_post"]["convt"]
        w = convt["weight"]
        if "scale" in convt:
            if self.normalize_final_conv:
                w = w / w.square().sum().sqrt().clamp_min(1e-12)
            w = w * convt["scale"]
        out["dec_post"] = {
            "conv": merge_conv_bn(params["dec_post"]["conv"],
                                  params["dec_post"]["bn"],
                                  stats["dec_post"]["bn"]),
            "convt": {"weight": w, "bias": convt["bias"]},
        }
        folded_stats = {
            "enc_pre": {}, "encoder": [{} for _ in out["encoder"]],
            "rf_pre": {}, "rf_post": {},
            "rf_blocks": [{} for _ in out["rf_blocks"]],
            "decoder": [{} for _ in out["decoder"]], "dec_post": {},
        }
        return {"params": out, "stats": folded_stats}

    def _block_fold(self, bp: Params, bs: Params) -> Params:
        """Fold one block: post-BN into the fc, pre-norm into GRU/QKV
        inputs."""
        eps = self.rf.eps
        rnn = {k: (fnn.maybe_wn_weight(bp["rnn"], k) if k.startswith("weight")
                   else bp["rnn"][k])
               for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        qkv_w = fnn.maybe_wn_weight(bp["attn"]["qkv"], "weight")
        qkv = {"weight": qkv_w}
        if "bias" in bp["attn"]["qkv"]:
            qkv["bias"] = bp["attn"]["qkv"]["bias"]
        nb: Params = {
            "rnn_fc": fold_fc_bn(bp["rnn_fc"], bp["rnn_post_norm"],
                                 bs["rnn_post_norm"], eps),
            "attn_fc": fold_fc_bn(bp["attn_fc"], bp["attn_post_norm"],
                                  bs["attn_post_norm"], eps),
            "rnn_post_norm": None,
            "attn_post_norm": None,
        }
        if self.rf.pre_norm:
            st = bs["attn_pre_norm"]
            std = torch.sqrt(st["var"] + eps)
            beta = -st["mean"] / std
            qkv_bias = qkv.get("bias", qkv_w.new_zeros(qkv_w.shape[0]))
            qkv = {"weight": qkv_w / std, "bias": qkv_bias + qkv_w @ beta}
            rnn = fold_prenorm_into_rnn(rnn, bs["rnn_pre_norm"], eps)
        nb["rnn"] = rnn
        nb["attn"] = {"qkv": qkv}
        if "pe" in bp:
            nb["pe"] = bp["pe"]
        return nb
