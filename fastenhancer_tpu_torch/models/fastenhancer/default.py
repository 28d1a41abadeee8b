"""FastEnhancer (RNNFormer): training, inference and streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/default.py. One
parameter tree (nested dicts and lists of tensors, the JAX package's
{"params", "stats"} layout, so `utils/bridge.py` moves it across by path)
serves the offline `forward` and the per-hop `streaming_step`. `fold()`
strips weight norm and merges BatchNorm into the convs and fcs; folded and
unfolded trees run through the same code (a conv applies BN only if its
subtree has one).

`forward(train=True, row_mask=...)` is the training graph: train-mode
BatchNorm over the batch (rows with row_mask 0 left out of the statistics)
and the time GRU as nn.gru's differentiable loop (no kernel runs in a
train step: the GRU-scan kernel has no backward); it returns the new BN
statistics. With `remat` (train.remat) each conv unit and each block runs
under torch.utils.checkpoint, as the JAX package's jax.checkpoint: the
backward recomputes their insides instead of keeping them, and each unit
returns its new statistics rather than writing them, so the recompute
changes nothing. The offline eval forward runs each block's time GRU as one
`gru_scan` launch (ops/gru_scan.py). `streaming_step_fused` runs the
RNNFormer block stack as one CUDA kernel (ops/rnnformer_stack.py) on folded
variables: the serving and benchmark path of FastEnhancer_B.
`streaming_step_fused_frame` runs the whole spec->mask model as one CUDA
kernel (ops/fused_frame.py). `streaming_chunk` (and `stream(chunk_frames=C)`)
is the throughput form of streaming: C hops a step, the network
time-batched over the chunk and each block's time GRU one `gru_scan` launch
over the C frames from the carried state.

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
from torch.utils.checkpoint import checkpoint

from ... import nn as fnn
from ...functional import (
    STFTConfig,
    compress,
    uncompress,
    compressed_stft,
    compressed_istft,
    stft_streaming_chunk,
    istft_streaming_chunk,
    init_stft_carry,
    init_istft_carry,
)
from ...ops.fused_frame import fused_frame_step, plan_frame
from ...ops.gru_scan import gru_fused
from ...ops.rnnformer_stack import plan_stack, rnnformer_stack_step
from ...utils.tree import tree_map, tree_paths
from ..streaming import stream_hops

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def _put(tree: tp.Optional[tp.Any], key: tp.Any,
         value: tp.Optional[Params]) -> None:
    """tree[key] = value where both are given (a train forward's new
    statistics into model_forward's copy of the stats tree)."""
    if tree is not None and value is not None:
        tree[key] = value


def _wn_suffix(torch_weight_name: str, sub: tp.Optional[str]) -> str:
    """weight-norm {g, v} leaves -> torch parametrization key names."""
    if sub is None:
        return torch_weight_name
    which = "original0" if sub == "g" else "original1"
    return f"parametrizations.{torch_weight_name}.{which}"


def _torch_name_default(path: tp.Tuple[str, ...], prepost: str = "rf",
                        block: str = "rf_block") -> str:
    """Param-tree path -> the reference's torch parameter name, so that
    `train.optimizer_groups` regexes apply unchanged. A copy of the JAX
    module's mapping: enc_pre.{0 conv,1 bn}, encoder.{i}.{0,1},
    rf_pre.{0 lin,1 conv,2 bn},
    rf_block.{i}.{rnn,rnn_fc,rnn_post_norm,attn.qkv,attn_fc,attn_post_norm,
    pe}, decoder.{i}.{0,1,3,4}, dec_post.{0,1,3}; the dprnn and dpt
    variants rename the prefixes (`prepost`: dprnn_pre, dpt_pre; `block`:
    dprnn_block, dpt_block)."""
    head, rest = path[0], path[1:]
    if head in ("enc_pre", "dec_post", "encoder"):
        if head == "encoder":
            prefix = f"encoder.{rest[0]}"
            rest = rest[1:]
        else:
            prefix = head
        mod, leaf = rest[0], rest[1]
        idx = {"conv": 0, "bn": 1, "convt": 3}.get(mod)
        if idx is not None:
            return f"{prefix}.{idx}.{leaf}"
    if head in ("rf_pre", "rf_post"):
        mod, leaf = rest[0], rest[1]
        idx = {"lin": 0, "conv": 1, "bn": 2}[mod]
        side = "pre" if head == "rf_pre" else "post"
        return f"{prepost}_{side}.{idx}.{leaf}"
    if head == "rf_blocks":
        i, mod = rest[0], rest[1]
        prefix = f"{block}.{i}"
        if mod == "rnn":
            leaf = rest[2]
            sub = rest[3] if len(rest) > 3 else None
            if leaf.startswith("weight"):
                return f"{prefix}.rnn.{_wn_suffix(leaf + '_l0', sub)}"
            return f"{prefix}.rnn.{leaf}_l0"
        if mod == "attn":
            leaf = rest[3]  # ("attn", "qkv", leaf[, sub])
            sub = rest[4] if len(rest) > 4 else None
            if leaf == "weight":
                return f"{prefix}.attn.qkv.{_wn_suffix('weight', sub)}"
            return f"{prefix}.attn.qkv.{leaf}"
        if mod == "pe":
            return f"{prefix}.pe"
        return f"{prefix}.{mod}.{rest[2]}"
    if head == "decoder":
        i, mod, leaf = rest[0], rest[1], rest[2]
        idx = {"conv1": 0, "bn1": 1, "conv2": 3, "bn2": 4}[mod]
        return f"decoder.{i}.{idx}.{leaf}"
    raise KeyError(f"unmapped param path: {path}")


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

    # model_forward_fused(variables, plan, spec, h) threads one carry
    # value, so the spec2spec step can run it (scripts/export.py)
    spec2spec_fused = True

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
        self.activation = activation
        self.act = fnn.get_activation(activation)
        self.hop_size = hop_size
        self.stft_cfg = STFTConfig(
            n_fft=n_fft, hop_size=hop_size, win_size=win_size,
            win_type=window, normalized=stft_normalized, method=stft_method)
        self.mask_name = mask
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
        # the final ConvTranspose's scale: variants set final_scale in
        # {True, False, "exp"} and its initializer after this __init__, so
        # both are read at init, apply and fold time
        self.final_scale: tp.Union[bool, str] = True
        self.final_scale_init: str = "one"
        # train.remat, set by the training wrapper: checkpoint each conv unit
        # and each block in a train forward
        self.remat = False
        # row inclusion mask [B] for train-mode BatchNorm statistics, held
        # for the duration of forward(train=True, row_mask=...); None = every
        # row is real
        self._row_mask: tp.Optional[Tensor] = None

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

        def conv_bn(out_ch: int, in_ch: int, k: int, site: str):
            return self._conv_block_init(g, out_ch, in_ch, k, site, dev)

        k0 = self.kernel_size[0]
        params["enc_pre"], stats["enc_pre"] = conv_bn(
            c, 2 * self.stride, k0 // self.stride, "enc_pre")
        params["encoder"], stats["encoder"] = [], []
        for k in self.kernel_size[1:]:
            p, s = conv_bn(c, c, k, "encoder")
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
        p, stats["rf_pre"] = conv_bn(self.block_channels, c, 1, "rf_pre")
        params["rf_pre"] = {"lin": {"weight": pre_w}, **p}
        p, stats["rf_post"] = conv_bn(c, self.block_channels, 1, "rf_post")
        params["rf_post"] = {"lin": {"weight": post_w}, **p}

        params["rf_blocks"], stats["rf_blocks"] = [], []
        for i in range(self.num_blocks):
            bp, bs = self._block_init(g, i, dev)
            params["rf_blocks"].append(bp)
            stats["rf_blocks"].append(bs)

        params["decoder"], stats["decoder"] = [], []
        for k in self.kernel_size[:0:-1]:
            p1, s1 = conv_bn(c, 2 * c, 1, "decoder1")
            p2, s2 = conv_bn(c, c, k, "decoder2")
            # the norms as bn1/bn2 (BatchNorm) or gn1/gn2 (the ln ablation's
            # GroupNorm), the units' statistics only where they have any
            unit = {"conv1": p1["conv"], "conv2": p2["conv"]}
            for tag, pp in (("1", p1), ("2", p2)):
                for norm in ("bn", "gn"):
                    if norm in pp:
                        unit[f"{norm}{tag}"] = pp[norm]
            params["decoder"].append(unit)
            stats["decoder"].append({"bn1": s1["bn"], "bn2": s2["bn"]}
                                    if "bn" in s1 else {})

        p1, s1 = conv_bn(c, 2 * c, 1, "dec_post")
        convt = fnn.torch_convtranspose1d_init(g, c, 2, k0, True, dev)
        if self.final_scale is not False:
            convt["scale"] = self._final_scale_init(convt, k0)
        params["dec_post"] = {**p1, "convt": convt}
        stats["dec_post"] = s1
        return {"params": params, "stats": stats}

    def _conv_block_init(self, g: torch.Generator, out_ch: int, in_ch: int,
                         k: int, site: str, device: torch.device
                         ) -> tp.Tuple[Params, Params]:
        """One conv + norm unit -> (params, stats). `site` names where it
        sits (enc_pre, encoder, rf_pre, rf_post, decoder1, decoder2,
        dec_post), so that a variant can change the norm kind, the conv's
        rank or its bias per site."""
        del site
        bn_p, bn_s = fnn.init_batch_norm(out_ch, device)
        return ({"conv": fnn.torch_conv1d_init(g, out_ch, in_ch, k, False,
                                               device), "bn": bn_p},
                {"bn": bn_s})

    def _final_scale_init(self, convt: Params, k0: int) -> Tensor:
        """The ConvTranspose scale's initial value (JAX default.py:354-371);
        a "<mean>_<std>" init also sets the bias to <mean>, in place."""
        w = convt["weight"]
        scale = torch.ones(1, device=w.device)
        if self.normalize_final_conv:
            fsi = self.final_scale_init
            norm = w.square().sum().sqrt()[None]
            if fsi == "1/sqrt(fan_in)":
                scale = scale / math.sqrt(self.channels * k0 // self.stride)
            elif fsi == "||weight||":
                scale = norm
            elif fsi == "zero":
                scale = torch.zeros(1, device=w.device)
            elif fsi != "one":
                mean, std = map(float, fsi.split("_"))
                scale = norm * std
                convt["bias"] = torch.full_like(convt["bias"], mean)
        if self.final_scale == "exp":
            scale = torch.log(scale.clamp_min(1e-5))
        return scale

    def _convt_scale(self, convt: Params) -> Tensor:
        """The effective multiplier of an unfolded ConvTranspose weight."""
        return (torch.exp(convt["scale"]) if self.final_scale == "exp"
                else convt["scale"])

    def _block_init(self, g: torch.Generator, i: int,
                    dev: torch.device) -> tp.Tuple[Params, Params]:
        """One RNNFormer block: time GRU + frequency MHSA with post-BN
        residuals."""
        rf = self.rf
        ch = rf.channels
        rnn, rnn_out = self._time_rnn_init(g, ch, dev)
        attn = fnn.init_attention(g, ch, rf.attn_bias, dev)
        if self.weight_norm:
            attn["qkv"]["weight"] = fnn.to_wn(attn["qkv"]["weight"])
        bn_rnn_p, bn_rnn_s = fnn.init_batch_norm(ch, dev)
        bn_attn_p, bn_attn_s = fnn.init_batch_norm(ch, dev)
        bp: Params = {
            "rnn": rnn,
            "rnn_fc": fnn.torch_linear_init(g, ch, rnn_out, False, dev),
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

    # -- the blocks' time RNN: the hooks a variant with another RNN overrides

    def _time_rnn_init(self, g: torch.Generator, ch: int,
                       dev: torch.device) -> tp.Tuple[Params, int]:
        """-> (the time GRU's params, the width rnn_fc reads)."""
        rnn = fnn.init_gru(g, ch, ch, dev)
        if self.weight_norm:
            rnn["weight_ih"] = fnn.to_wn(rnn["weight_ih"])
            rnn["weight_hh"] = fnn.to_wn(rnn["weight_hh"])
        return rnn, ch

    def _time_rnn_apply(self, p: Params, y: Tensor, h0: tp.Optional[Tensor],
                        train: bool) -> tp.Tuple[Tensor, Tensor]:
        """y [T, N, C] -> (ys [T, N, width rnn_fc reads], h_T [N, C]). In
        eval one gru_scan launch (ops/gru_scan.py); in training nn.gru's
        differentiable loop, as the JAX package keeps lax.scan for
        training."""
        if h0 is None:
            h0 = y.new_zeros(y.shape[1:])
        gru = fnn.gru if train else gru_fused
        return gru(p, y, h0)

    def _time_rnn_fold(self, rnn: Params, pre_norm: tp.Optional[Params]
                       ) -> Params:
        """Strip weight norm; fold the pre-norm statistics `pre_norm` (None
        without pre-norms) into the input weights."""
        rnn = {k: (fnn.maybe_wn_weight(rnn, k) if k.startswith("weight")
                   else rnn[k])
               for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        if pre_norm is None:
            return rnn
        return fold_prenorm_into_rnn(rnn, pre_norm, self.rf.eps)

    # -- row mask -> BN inclusion weights ------------------------------------

    def _bn_w_bt(self, b: int, t: int) -> tp.Optional[Tensor]:
        """[B*T, 1, 1] weight for [B*T, F, C] layouts (b-major fold)."""
        m = self._row_mask
        if m is None:
            return None
        return m.float().repeat_interleave(t)[:, None, None]

    def _bn_w_tb(self) -> tp.Optional[Tensor]:
        """[1, B, 1, 1] weight for [T, B, F, C] layouts."""
        m = self._row_mask
        if m is None:
            return None
        return m.float()[None, :, None, None]

    def _bn_w_b(self, ndim: int) -> tp.Optional[Tensor]:
        """[B, 1, ...] weight for batch-leading layouts (time_kernel's)."""
        m = self._row_mask
        if m is None:
            return None
        return m.float().reshape(m.shape[0], *([1] * (ndim - 1)))

    # -- building blocks ------------------------------------------------------

    def _conv_bn_act(self, p: Params, s: tp.Optional[Params], x: Tensor, *,
                     stride: int = 1, padding: int = 0, act: bool = True,
                     eps: float = 1e-5, train: bool = False,
                     bw: tp.Optional[Tensor] = None
                     ) -> tp.Tuple[Tensor, tp.Optional[Params]]:
        """conv (+BN, or the ln ablation's GroupNorm, if the subtree has
        one) (+activation); x: [N, F, Cin] -> (y, {"bn": the new running
        statistics} where a BN ran in train mode, else None). In train mode
        the BN's statistics are weighted by `bw`; with self.remat the unit
        runs under checkpoint (JAX default.py:443-460)."""
        def unit(p: Params, s: tp.Optional[Params], x: Tensor,
                 bw: tp.Optional[Tensor]
                 ) -> tp.Tuple[Tensor, tp.Optional[Params]]:
            conv = dict(p["conv"])
            conv["weight"] = fnn.maybe_wn_weight(p["conv"], "weight")
            y = fnn.conv1d_cl(conv, x, stride=stride, padding=padding)
            new_s = None
            if p.get("bn") is not None:
                y, st = fnn.batch_norm(p["bn"], s["bn"], y, train=train,
                                       eps=eps, weight=bw)
                if train:
                    new_s = {"bn": st}
            elif p.get("gn") is not None:
                y = fnn.layer_norm_fc(p["gn"], y, eps=eps)
            return (self.act(y) if act else y), new_s

        if train and self.remat:
            return checkpoint(unit, p, s, x, bw, use_reentrant=False)
        return unit(p, s, x, bw)

    def _scaled_convt(self, p: Params, x: Tensor) -> Tensor:
        """ScaledConvTranspose1d; an unfolded tree carries the scale."""
        w = p["weight"]
        if "scale" in p:
            if self.normalize_final_conv:
                norm = w.square().sum().sqrt()
                w = w / norm.clamp_min(1e-12) * self._convt_scale(p)
            else:
                w = w * self._convt_scale(p)
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
        stats). train=True runs every BatchNorm in train mode and returns
        their new statistics (a new tree; `stats` is left as it is)."""
        new_stats = tree_map(lambda a: a, stats) if train else None
        x, x_res, skips, b, t = self._encode(params, stats, spec, new_stats)
        x, h_out = self._blocks(params, stats, x, h0, new_stats)
        mask = self._decode(params, stats, x, x_res, skips, b, t,
                            spec.shape[1], new_stats)
        return mask, h_out, stats if new_stats is None else new_stats

    def _blocks(self, params: Params, stats: Params, x: Tensor,
                h0: tp.Optional[tp.List[tp.Any]],
                new_stats: tp.Optional[Params] = None
                ) -> tp.Tuple[Tensor, tp.List[tp.Any]]:
        """The block stack, x [T, B, F', C'] -> (x, each block's carry).
        With `new_stats` (model_forward's copy of stats) every block runs in
        train mode and its new statistics are written there."""
        train = new_stats is not None
        extra = self._block_extra(params)
        h_out: tp.List[tp.Any] = []
        for i, (bp, bs) in enumerate(zip(params["rf_blocks"],
                                         stats["rf_blocks"])):
            x, h_t, s = self._apply_block(bp, bs, x,
                                          None if h0 is None else h0[i],
                                          train, **extra)
            h_out.append(h_t)
            if s is not None:
                new_stats["rf_blocks"][i] = s
        return x, h_out

    def _block_extra(self, params: Params) -> Params:
        """Keyword arguments every block takes besides its own subtree
        (the dptransformer's shared time bias); none here."""
        del params
        return {}

    def _apply_block(self, p: Params, s: Params, x: Tensor, h0: tp.Any,
                     train: bool, **extra: tp.Any
                     ) -> tp.Tuple[Tensor, tp.Any, tp.Optional[Params]]:
        """_block_apply, under checkpoint with self.remat in a train
        forward (JAX default.py:639-647): the backward keeps the block's
        inputs only and recomputes its GRU loop and attention. The BN
        weights of the row mask are taken here and passed in, since the
        recompute runs after forward() has dropped the mask."""
        bw = self._bn_w_tb() if train else None
        if train and self.remat:
            return checkpoint(self._block_apply, p, s, x, h0, True, bw,
                              use_reentrant=False, **extra)
        return self._block_apply(p, s, x, h0, train, bw, **extra)

    def _encode(self, params: Params, stats: Params, spec: Tensor,
                new_stats: tp.Optional[Params] = None
                ) -> tp.Tuple[Tensor, Tensor, tp.List[Tensor], int, int]:
        """Everything before the block stack: spec [B, F, T, 2] ->
        (x [T, B, F', C'], rf_pre residual, skips, b, t). With `new_stats`
        (model_forward's copy of stats) the BNs run in train mode and write
        their new statistics there."""
        b, f_in, t, _ = spec.shape
        train = new_stats is not None
        bw = self._bn_w_bt(b, t) if train else None
        x = spec.permute(0, 2, 1, 3).reshape(b * t, f_in, 2)
        x = self._strided_reshape(x)
        x, s = self._conv_bn_act(params["enc_pre"], stats["enc_pre"], x,
                                 train=train, bw=bw)
        _put(new_stats, "enc_pre", s)
        skips = [x]
        for i, (p, st) in enumerate(zip(params["encoder"], stats["encoder"])):
            x_in = x
            k = self.kernel_size[1 + i]
            x, s = self._conv_bn_act(p, st, x, padding=(k - 1) // 2,
                                     train=train, bw=bw)
            _put(None if new_stats is None else new_stats["encoder"], i, s)
            skips.append(x)
            if self.resnet:
                x = x + x_in
        x_res = x
        x = torch.einsum("oF,nFc->noc", params["rf_pre"]["lin"]["weight"], x)
        x, s = self._conv_bn_act(params["rf_pre"], stats["rf_pre"], x,
                                 act=False, train=train, bw=bw)
        _put(new_stats, "rf_pre", s)
        x = x.reshape(b, t, self.block_freq, x.shape[-1]).transpose(0, 1)
        return x, x_res, skips, b, t

    def _decode(self, params: Params, stats: Params, x: Tensor, x_res: Tensor,
                skips: tp.List[Tensor], b: int, t: int, f_in: int,
                new_stats: tp.Optional[Params] = None) -> Tensor:
        """Everything after the block stack: x [T, B, F', C'] -> mask
        [B, F, T, 2]. `new_stats` as in _encode."""
        train = new_stats is not None
        bw = self._bn_w_bt(b, t) if train else None
        x = x.transpose(0, 1).reshape(b * t, self.block_freq, x.shape[-1])
        x = torch.einsum("oF,nFc->noc", params["rf_post"]["lin"]["weight"], x)
        x, s = self._conv_bn_act(params["rf_post"], stats["rf_post"], x,
                                 act=False, train=train, bw=bw)
        _put(new_stats, "rf_post", s)
        if self.resnet:
            x = x + x_res
        for i, (p, st) in enumerate(zip(params["decoder"], stats["decoder"])):
            x_in = x
            x = torch.cat([x, skips.pop()], dim=-1)
            unit1 = {"conv": p["conv1"], "bn": p.get("bn1"),
                     "gn": p.get("gn1")}
            unit2 = {"conv": p["conv2"], "bn": p.get("bn2"),
                     "gn": p.get("gn2")}
            y, s1 = self._conv_bn_act(unit1, {"bn": st.get("bn1")}, x,
                                      train=train, bw=bw)
            k = self.kernel_size[len(self.kernel_size) - 1 - i]
            x, s2 = self._conv_bn_act(unit2, {"bn": st.get("bn2")}, y,
                                      padding=(k - 1) // 2, train=train,
                                      bw=bw)
            if s1 is not None:
                new_stats["decoder"][i] = {"bn1": s1["bn"], "bn2": s2["bn"]}
            if self.resnet:
                x = x + x_in
        x = torch.cat([x, skips.pop()], dim=-1)
        x, s = self._conv_bn_act(params["dec_post"], stats["dec_post"], x,
                                 train=train, bw=bw)
        _put(new_stats, "dec_post", s)
        x = self._scaled_convt(params["dec_post"]["convt"], x)  # [B*T, F, 2]
        mask = self.mask_act(x)
        return mask.reshape(b, t, f_in, 2).permute(0, 2, 1, 3)

    def _block_apply(self, p: Params, s: Params, x: Tensor,
                     h0: tp.Optional[Tensor], train: bool = False,
                     bw: tp.Optional[Tensor] = None
                     ) -> tp.Tuple[Tensor, Tensor, tp.Optional[Params]]:
        """x: [T, B, F', C] -> (x, h_T [B*F', C], the block's new statistics
        in train mode, else None); the time RNN is `_time_rnn_apply`. In
        train mode the BNs' statistics are weighted by `bw` [1, B, 1, 1]."""
        rf = self.rf
        t, b, f, c = x.shape
        new_s = dict(s) if train else None

        def bn(bn_p: tp.Optional[Params], key: str, y: Tensor) -> Tensor:
            y, st = fnn.batch_norm(bn_p, s[key], y, train=train, eps=rf.eps,
                                   weight=bw)
            if train:
                new_s[key] = st
            return y

        # --- time GRU ---
        x_in = x
        y = x
        if s and "rnn_pre_norm" in s:
            y = bn(None, "rnn_pre_norm", y)
        y, h_t = self._time_rnn_apply(p["rnn"], y.reshape(t, b * f, c), h0,
                                      train)
        y = fnn.linear(p["rnn_fc"], y.reshape(t, b, f, -1))
        if p.get("rnn_post_norm") is not None:
            y = bn(p["rnn_post_norm"], "rnn_post_norm", y)
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
            y = bn(None, "attn_pre_norm", y)
        y = fnn.attention(p["attn"], y.reshape(t * b, f, c), rf.num_heads)
        y = fnn.linear(p["attn_fc"], y.reshape(t, b, f, c))
        if p.get("attn_post_norm") is not None:
            y = bn(p["attn_post_norm"], "attn_post_norm", y)
        if rf.post_act:
            y = self.act(y)
        return y + x_in, h_t, new_s

    # -- offline graph (wav -> wav) --------------------------------------------

    @staticmethod
    def complex_mask_mul(spec: Tensor, mask: Tensor) -> Tensor:
        re = spec[..., 0] * mask[..., 0] - spec[..., 1] * mask[..., 1]
        im = spec[..., 0] * mask[..., 1] + spec[..., 1] * mask[..., 0]
        return torch.stack([re, im], dim=-1)

    def forward(self, variables: Params, wav: Tensor, train: bool = False,
                row_mask: tp.Optional[Tensor] = None
                ) -> tp.Tuple[Tensor, Tensor, Params]:
        """wav [B, T] -> (wav_hat [B, T], spec_hat compressed [B, F, T', 2],
        stats; the new BN statistics when train=True).

        row_mask [B] (1 real, 0 zero-padded) leaves padded rows out of the
        train-mode BN statistics. It is held on self for the duration of
        the call, so the BN call sites, which see folded [B*T, ...] and
        [T, B, ...] layouts, derive their weights from it."""
        params, stats = variables["params"], variables["stats"]
        self._row_mask = row_mask if train else None
        try:
            spec = self.stft(wav)
            mask, _, stats = self.model_forward(params, stats, spec,
                                                train=train)
            spec_hat = self.complex_mask_mul(spec, mask)
            wav_hat = compressed_istft(spec_hat, self.stft_cfg,
                                       self.input_compression,
                                       discard_last_freq_bin=True,
                                       length=wav.shape[-1])
        finally:
            self._row_mask = None
        return wav_hat, spec_hat, stats

    def stft(self, wav: Tensor) -> Tensor:
        """Compressed STFT of a clean target (for the losses)."""
        return compressed_stft(wav, self.stft_cfg, self.input_compression,
                               discard_last_freq_bin=True)

    # -- streaming --------------------------------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """{"stft", "istft", "h"} rolling state for `batch` streams. h is a
        list of per-block carries (`_block_carry_init`), or stacked
        [NB, B*F', C] with fused=True (the kernel's layout). Rows are
        batch-major. Variants with another fused state override this."""
        h = [self._block_carry_init(batch, dtype, device)
             for _ in range(self.num_blocks)]
        return {
            "stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
            "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
            "h": torch.stack(h) if fused else h,
        }

    def _block_carry_init(self, batch: int, dtype: torch.dtype,
                          device: tp.Union[str, torch.device]) -> tp.Any:
        """One block's streaming state: the GRU carry [B*F', C]."""
        return torch.zeros(batch * self.block_freq, self.block_channels,
                           dtype=dtype, device=device)

    def _stream_front(self, carry: Params, wav: Tensor
                      ) -> tp.Tuple[Tensor, Tensor]:
        """STFT of C hops (wav [B, hop*C]) + last-bin drop + compress ->
        (spec [B, F, C, 2], new stft cache)."""
        spec, stft_c = stft_streaming_chunk(wav, carry["stft"], self.stft_cfg)
        return compress(spec[:, :-1], self.input_compression), stft_c

    def _stream_back(self, spec: Tensor, mask: Tensor, carry: Params,
                     stft_c: Tensor, h_t) -> tp.Tuple[Params, Tensor]:
        """Mask multiply + uncompress + last-bin re-append + iSTFT of the C
        frames. h_t becomes the new carry's "h" (None for a variant that
        keeps its block state under other keys)."""
        spec_hat = uncompress(self.complex_mask_mul(spec, mask),
                              self.input_compression)
        spec_hat = torch.cat([spec_hat, torch.zeros_like(spec_hat[:, :1])],
                             dim=1)
        wav_out, istft_c = istft_streaming_chunk(spec_hat, carry["istft"],
                                                 self.stft_cfg)
        return {"stft": stft_c, "istft": istft_c, "h": h_t}, wav_out

    def streaming_step(self, variables: Params, carry: Params,
                       wav_hop: Tensor) -> tp.Tuple[Params, Tensor]:
        """One hop: wav_hop [B, hop] -> (new_carry, wav_out [B, hop]); the
        output is delayed n_fft - hop samples. Given C hops [B, hop*C] it is
        `streaming_chunk`."""
        spec, stft_c = self._stream_front(carry, wav_hop)
        mask, h_t, _ = self.model_forward(variables["params"],
                                          variables["stats"], spec,
                                          h0=carry["h"])
        return self._stream_back(spec, mask, carry, stft_c, h_t)

    def streaming_chunk(self, variables: Params, carry: Params,
                        wav_chunk: Tensor) -> tp.Tuple[Params, Tensor]:
        """C hops: wav_chunk [B, hop*C] -> (new_carry, wav_out [B, hop*C]),
        the math of C single-hop steps with the encoder, decoder and
        attention time-batched over the chunk and each block's time GRU one
        gru_scan over the C frames from the carried state (which it keeps
        in float32 over the chunk). The carry is init_streaming_carry()'s
        (fused=False)."""
        return self.streaming_step(variables, carry, wav_chunk)

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

    # -- whole-frame streaming (CUDA kernel) -------------------------------------

    def build_frame_plan(self, variables: Params,
                         dtype: tp.Optional[torch.dtype] = None) -> Params:
        """Pack FOLDED variables for the whole-frame kernel
        (ops/fused_frame.py): encoder, rf_pre, block stack, rf_post, decoder
        and ConvTranspose in one launch. Raises ValueError outside the
        kernel's envelope (use build_stack_plan then)."""
        return plan_frame(self, variables, dtype=dtype)

    def streaming_step_fused_frame(self, variables: Params, plan: Params,
                                   carry: Params, wav_hop: Tensor
                                   ) -> tp.Tuple[Params, Tensor]:
        """streaming_step with the whole spec->mask model as one kernel per
        frame; only the STFT/iSTFT steps and the complex mask multiply run
        around it. Same math as streaming_step on folded variables; the
        carry is init_streaming_carry(fused=True)'s."""
        spec, stft_c = self._stream_front(carry, wav_hop)
        x = self._strided_reshape(spec[:, :, 0, :]).contiguous()
        h = carry["h"]
        if isinstance(h, (list, tuple)):
            h = torch.stack(h)
        mask8, h_t = fused_frame_step(
            plan, x, h, num_blocks=self.num_blocks,
            num_heads=self.rf.num_heads, n_enc=len(self.kernel_size) - 1,
            enc_ks=tuple(self.kernel_size[1:]), f_enc=self.freq,
            block_freq=self.block_freq, stride=self.stride,
            resnet=self.resnet, mask=self.mask_name)
        mask = mask8.reshape(mask8.shape[0], -1, 2)[:, :, None, :]
        return self._stream_back(spec, mask, carry, stft_c, h_t)

    def stream(self, variables: Params, wav: Tensor, chunk_frames: int = 1,
               fused_plan: tp.Optional[Params] = None) -> Tensor:
        """Whole-utterance streaming. wav [B, hop*T] -> [B, hop*T'].
        One hop per step (T' = T), or with chunk_frames=C > 1 one
        `streaming_chunk` of C hops per step, the tail cut to a multiple of
        C (T' = (T // C) * C), as the JAX package does. `fused_plan`
        (build_stack_plan() of folded variables) runs the block stack as one
        kernel per frame; it takes one hop per step (ValueError with
        chunk_frames > 1)."""
        return stream_hops(self, variables, wav, chunk_frames, fused_plan)

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
            w = w * self._convt_scale(convt)
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
        rnn = self._time_rnn_fold(bp["rnn"], bs.get("rnn_pre_norm")
                                  if self.rf.pre_norm else None)
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
        nb["rnn"] = rnn
        nb["attn"] = {"qkv": qkv}
        if "pe" in bp:
            nb["pe"] = bp["pe"]
        return nb

    # -- misc ----------------------------------------------------------------

    # the reference's module prefixes of rf_pre/rf_post and the blocks
    tname_prepost = "rf"
    tname_block = "rf_block"

    def fixed_param_paths(self) -> tp.List[tp.Tuple[str, ...]]:
        """Param-tree paths that are buffers in the reference (not trained)."""
        fixed: tp.List[tp.Tuple[str, ...]] = []
        if (self.pre_post_init is not None
                and self.pre_post_init.endswith("_fixed")):
            fixed.append(("rf_pre", "lin", "weight"))
            fixed.append(("rf_post", "lin", "weight"))
        if self.rf.positional_embedding == "fixed":
            fixed.append(("rf_blocks", "0", "pe", "weight"))
        return fixed

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """A param-tree path's name in the reference's torch model, so that
        `train.optimizer_groups` regexes from the reference configs apply
        unchanged (configs/fastenhancer/t.yaml's optimizer_groups)."""
        return _torch_name_default(path, self.tname_prepost, self.tname_block)

    def num_params(self, params: Params) -> int:
        """Trainable parameter count (fixed buffers excluded)."""
        fixed = set(self.fixed_param_paths())
        return sum(leaf.numel() for path, leaf in tree_paths(params)
                   if path not in fixed)
