"""LiSenNet baseline (streamable re-implementation), inference and
streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/lisennet.py (reference:
models/lisennet/model.py): magnitude and phase features (group delay and
instantaneous-frequency deviation), a 3-stage split-band conv encoder
(DSConv: a low-band and a high-band kernel, a 1-frame time cache), N dual-
path blocks (a frequency biGRU and a time GRU behind LayerNorm([F, C])
pre-norms, then a ConvolutionalGLU with a depthwise 3x3 time-causal conv and
a 2-frame cache), and a sub-pixel upsampling mask decoder with a learnable
sigmoid.

As in the JAX package, the phase differences keep the reference's TRAINING
sign convention in every mode (its streaming ONNX graph uses the opposite
sign; COMPONENTS.md:70), so streaming equals offline.

In eval every GRU is the GRU-scan kernel (ops/gru_scan.py): the frequency
biGRU two launches (`bigru_fused`, N = B*T rows over the 32 bins), the time
GRU one (`gru_fused`, from its carried state), 3 a block, 6 a frame or chunk
at the recipe's 2 blocks. `streaming_chunk` (and `stream(chunk_frames=C)`)
runs C hops a step, the time GRU one launch over the C frames.

Deliberate divergence from the JAX package: `_features` runs in float32
whatever the activation type (a bf16 spectrum is cast up, the stacked
features cast back), and the carried last-frame phase is float32. In bf16
JAX subtracts 2 pi (hop / n_fft) k, up to ~804 rad at k = 256, where a
bf16 ulp is 4 rad, so its IFD feature is rounding noise (ROADMAP queue 3;
tests/test_torch_baselines.py).

`forward(train=True)` is the training graph (JAX lisennet.py:305-370):
no norm keeps batch statistics, so it differs from eval only in its GRUs,
nn.gru's and nn.bigru's differentiable loops (no kernel runs in a train
step); the phase features stay float32. There is no fused stack plan: the
engine runs this model unfused.
"""
from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from .. import nn as fnn
from ..functional import (
    STFTConfig,
    compressed_stft,
    compressed_istft,
    init_stft_carry,
    init_istft_carry,
)
from ..ops.gru_scan import bigru_fused, gru_fused
from .streaming import spectral_step, stream_hops

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

_NO_PLAN = ("LiSenNet has no fused stack plan: serve it unfused "
            "(StreamingEngine(fused=False))")


def layer_norm_fc_affine(p: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """nn.LayerNorm([F, C]): normalize over the last two axes with an
    elementwise affine [F, C]; statistics and affine in float32, output in
    x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = (xf - mean).square().mean(dim=(-2, -1), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["weight"] + p["bias"]).to(x.dtype)


def prelu(p: Tensor, x: Tensor) -> Tensor:
    """Per-channel PReLU; p: [C] broadcast over the channel (last) axis."""
    return torch.where(x >= 0, x, p * x)


def _conv2d_cl(p: Params, x: Tensor, stride: tp.Tuple[int, int] = (1, 1),
               padding: tp.Tuple[int, int] = (0, 0)) -> Tensor:
    """x: [B, T, F, Cin] -> [B, T', F', Cout]; weight torch [Cout, Cin, kT,
    kF]; padding (time, freq), on both sides."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["weight"], p.get("bias"),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _dwconv2d_cl(p: Params, x: Tensor, padding: tp.Tuple[int, int]
                 ) -> Tensor:
    """Depthwise conv: weight torch [C, 1, kT, kF]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["weight"], p.get("bias"),
                 padding=padding, groups=p["weight"].shape[0])
    return y.permute(0, 2, 3, 1)


class Model(torch.nn.Module):
    """LiSenNet. Takes the reference's `model_kwargs` unchanged
    (configs/others/lisennet.yaml). The module holds the configuration only;
    weights live in the variables tree that `init` returns."""

    def __init__(
        self,
        num_channels: int = 16,
        n_blocks: int = 2,
        n_fft: int = 512,
        hop_size: int = 256,
        win_size: int = 512,
        window: tp.Optional[str] = "hann",
        input_compression: float = 0.3,
        normalized: bool = False,
        stft_method: str = "fft",
    ):
        super().__init__()
        if n_fft != 512:
            raise ValueError("the LiSenNet band geometry needs n_fft=512")
        self.c = num_channels
        self.n_blocks = n_blocks
        self.n_fft = n_fft
        self.hop_size = hop_size
        self.n_freqs = n_fft // 2 + 1
        self.input_compression = input_compression
        self.stft_cfg = STFTConfig(n_fft=n_fft, hop_size=hop_size,
                                   win_size=win_size, win_type=window,
                                   normalized=normalized, method=stft_method)
        self.dpr_freq = self.n_freqs // 8  # 32
        self.hdim = num_channels // 2 * 3

    # -- init -----------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """Fresh {"params", "stats"} on `device` with the JAX init's tree
        and distributions (torch-default uniform conv inits, unit norms,
        PReLU 0.25). Values are drawn on the CPU from `generator`."""
        c, g, dev = self.c, generator, torch.device(device)

        def conv2d(out_ch, in_ch, kt, kf):
            bound = 1.0 / math.sqrt(in_ch * kt * kf)
            return {"weight": fnn.uniform_init(g, (out_ch, in_ch, kt, kf),
                                               bound, dev),
                    "bias": fnn.uniform_init(g, (out_ch,), bound, dev)}

        def affine(rows, cols, names):
            return {names[0]: torch.ones(rows, cols, device=dev),
                    names[1]: torch.zeros(rows, cols, device=dev)}

        def prelu_init(ch):
            return torch.full((ch,), 0.25, device=dev)

        def dsconv(in_ch, out_ch, n_freqs):
            return {"low_conv": conv2d(out_ch, in_ch, 2, 3),
                    "high_conv": conv2d(out_ch, in_ch, 2, 5),
                    # CustomLayerNorm((1, F//2), stat_dims=(1,3)): affine
                    # over freq
                    "norm": affine(n_freqs // 2, 1, ("gamma", "beta")),
                    "act": prelu_init(out_ch)}

        P: Params = {"encoder": {
            "conv_1": {"conv": conv2d(c // 4, 3, 1, 1),
                       "norm": affine(257, 1, ("gamma", "beta")),
                       "act": prelu_init(c // 4)},
            "conv_2": dsconv(c // 4, c // 2, 257),
            "conv_3": dsconv(c // 2, c // 4 * 3, 128),
            "conv_4": dsconv(c // 4 * 3, c, 64),
        }}
        f, hdim = self.dpr_freq, self.hdim
        P["blocks"] = [{
            "intra_norm": affine(f, c, ("weight", "bias")),
            "intra_rnn": fnn.init_bigru(g, c, hdim // 2, dev),
            "intra_fc": fnn.torch_linear_init(g, c, hdim, True, dev),
            "inter_norm": affine(f, c, ("weight", "bias")),
            "inter_rnn": fnn.init_gru(g, c, hdim, dev),
            "inter_fc": fnn.torch_linear_init(g, c, hdim, True, dev),
            "glu": {
                # CustomLayerNorm((C, F), stat_dims=(1,3)): affine [F, C]
                "norm": affine(f, c, ("gamma", "beta")),
                "fc1": conv2d(4 * c, c, 1, 1),
                "dwconv": conv2d(2 * c, 1, 3, 3),
                "fc2": conv2d(c, 2 * c, 1, 1),
            },
        } for _ in range(self.n_blocks)]
        c3 = c // 4 * 3
        P["decoder"] = {
            "up1": {"low_conv": conv2d(c3, 2 * c, 1, 3),
                    "high_conv": conv2d(c3 * 3, 2 * c, 1, 3)},
            "up2": {"low_conv": conv2d(c // 2, c3 * 2, 1, 3),
                    "high_conv": conv2d(c // 2 * 3, c3 * 2, 1, 3)},
            "up3": {"low_conv": conv2d(c // 4, c, 1, 3),
                    "high_conv": conv2d(c3, c, 1, 3)},
            "mask_conv": {"conv1": conv2d(2, c // 4, 2, 2),
                          "norm": affine(257, 1, ("gamma", "beta")),
                          "act": prelu_init(2),
                          "conv2": conv2d(2, 2, 1, 1)},
            "lsigmoid": {"slope": torch.ones(self.n_freqs, 1, 1, device=dev)},
        }
        return {"params": P, "stats": {}}

    # -- pieces ---------------------------------------------------------------

    @staticmethod
    def _cln_freq(p: Params, x: Tensor) -> Tensor:
        """CustomLayerNorm((1|C, F), stat_dims=(1,3)) on torch [B,C,T,F]:
        normalize over (F, C) of each frame, affine per F (gamma [F, 1] or
        [F, C]). x: [B, T, F, C]; float32 inside, x's dtype out."""
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (xf - mean) / torch.sqrt(var + 1e-5)
        return (y * p["gamma"] + p["beta"]).to(x.dtype)

    def _dsconv(self, p: Params, x: Tensor, cache: tp.Optional[Tensor],
                n_freqs: int) -> tp.Tuple[Tensor, Tensor]:
        """x [B, T, F, Cin] -> ([B, T, F//2, Cout], cache [B, 1, F, Cin]):
        a (2, 3) kernel over the low quarter of the band, a (2, 5) kernel
        with freq stride 3 over the rest, time-causal over the cached
        frame."""
        b, _, f, cin = x.shape
        if cache is None:
            cache = x.new_zeros(b, 1, f, cin)
        x = torch.cat([cache, x], dim=1)
        low_f = n_freqs // 4
        y = torch.cat([
            _conv2d_cl(p["low_conv"], x[:, :, :low_f], padding=(0, 1)),
            _conv2d_cl(p["high_conv"], x[:, :, low_f:], stride=(1, 3),
                       padding=(0, 1))], dim=2)
        return prelu(p["act"], self._cln_freq(p["norm"], y)), x[:, -1:]

    @staticmethod
    def _usconv(p: Params, x: Tensor, n_freqs: int) -> Tensor:
        """x [B, T, F, Cin] -> [B, T, 2F, Cout]: a conv of the low half, and
        a sub-pixel (r = 3) conv of the high half whose output bin f*3 + r
        takes channels [r*Cout, (r+1)*Cout)."""
        low_f = n_freqs // 2
        x_low = _conv2d_cl(p["low_conv"], x[:, :, :low_f], padding=(0, 1))
        y = _conv2d_cl(p["high_conv"], x[:, :, low_f:], padding=(0, 1))
        b, t, f, c3 = y.shape
        y = y.reshape(b, t, f * 3, c3 // 3)
        return torch.cat([x_low, y], dim=2)

    def _glu(self, p: Params, x: Tensor, cache: tp.Optional[Tensor]
             ) -> tp.Tuple[Tensor, Tensor]:
        """ConvolutionalGLU with a 2-frame cache of its depthwise conv's
        input. x: [B, T, F, C] -> (x', cache [B, 2, F, 2C])."""
        b, _, f, _ = x.shape
        y = _conv2d_cl(p["fc1"], self._cln_freq(p["norm"], x))
        a, v = y.chunk(2, dim=-1)
        if cache is None:
            cache = x.new_zeros(b, 2, f, a.shape[-1])
        a = torch.cat([cache, a], dim=1)
        y = F.mish(_dwconv2d_cl(p["dwconv"], a, padding=(0, 1))) * v
        return _conv2d_cl(p["fc2"], y) + x, a[:, -2:]

    def _dpr(self, p: Params, x: Tensor, cache_rnn: tp.Optional[Tensor],
             cache_conv: tp.Optional[Tensor], train: bool = False
             ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """x [B, T, F, C] -> (x', the time GRU's h_T [B*F, hdim], the GLU's
        cache). 3 gru_scan launches in eval; nn.bigru's and nn.gru's loops
        in train."""
        b, t, f, c = x.shape
        bigru = fnn.bigru if train else bigru_fused
        gru = fnn.gru if train else gru_fused
        y = layer_norm_fc_affine(p["intra_norm"], x)
        y = bigru(p["intra_rnn"], y.reshape(b * t, f, c).transpose(0, 1))
        y = fnn.linear(p["intra_fc"], y.transpose(0, 1))
        x = y.reshape(b, t, f, c) + x

        y = layer_norm_fc_affine(p["inter_norm"], x)
        y = y.transpose(1, 2).reshape(b * f, t, c).transpose(0, 1)
        y, h_out = gru(p["inter_rnn"], y, cache_rnn)          # [T, BF, hdim]
        y = fnn.linear(p["inter_fc"], y)                      # [T, BF, C]
        x = y.transpose(0, 1).reshape(b, f, t, c).transpose(1, 2) + x

        x, cache_conv = self._glu(p["glu"], x, cache_conv)
        return x, h_out, cache_conv

    # -- phase features -------------------------------------------------------

    @staticmethod
    def _wrap(x: Tensor) -> Tensor:
        return torch.atan2(torch.sin(x), torch.cos(x))

    def _features(self, spec: Tensor, prev_pha: tp.Optional[Tensor]
                  ) -> tp.Tuple[Tensor, Tensor]:
        """spec (compressed) [B, F, T, 2] -> (features [B, T, F, 3]
        (magnitude, GD/pi, IFD/pi) in spec's dtype, the last frame's phase
        [B, 1, F] float32), the training conventions (Model.cal_*). Computed
        in float32 whatever spec's dtype (see the module docstring)."""
        x = spec.float().permute(0, 2, 1, 3)                  # [B, T, F, 2]
        mag = x.square().sum(dim=-1).sqrt()
        pha = torch.atan2(x[..., 1], x[..., 0])               # [B, T, F]
        b, t, f = pha.shape
        gd = self._wrap(torch.diff(pha, dim=2, prepend=pha.new_zeros(b, t, 1)))
        if prev_pha is None:
            prev_pha = pha.new_zeros(b, 1, f)
        x_if = pha - torch.cat([prev_pha, pha[:, :-1]], dim=1)
        shift = 2.0 * math.pi * (self.hop_size / self.n_fft)
        ifd = self._wrap(x_if - shift * torch.arange(f, dtype=pha.dtype,
                                                     device=pha.device))
        feats = torch.stack([mag, gd / math.pi, ifd / math.pi], dim=-1)
        return feats.to(spec.dtype), pha[:, -1:]

    # -- core network ---------------------------------------------------------

    def model_forward(self, params: Params, stats: Params, spec: Tensor,
                      h0: tp.Optional[Params] = None, train: bool = False
                      ) -> tp.Tuple[Tensor, Params, Params]:
        """Compressed spec [B, F, T, 2] -> (spec_hat, carry, stats). h0 is
        the streaming carry's "h" (None: zero caches); train=True runs the
        GRUs as differentiable loops (stats, empty, are returned as they
        are)."""
        P = params
        feats, last_pha = self._features(spec, None if h0 is None
                                         else h0["pha"])
        enc = P["encoder"]
        x1 = _conv2d_cl(enc["conv_1"]["conv"], feats)
        x1 = prelu(enc["conv_1"]["act"],
                   self._cln_freq(enc["conv_1"]["norm"], x1))
        caches = h0 if h0 is not None else {
            "enc": [None] * 3, "dpr_rnn": [None] * self.n_blocks,
            "dpr_conv": [None] * self.n_blocks, "dec": None}
        x2, c2 = self._dsconv(enc["conv_2"], x1, caches["enc"][0], 257)
        x3, c3 = self._dsconv(enc["conv_3"], x2, caches["enc"][1], 128)
        x4, c4 = self._dsconv(enc["conv_4"], x3, caches["enc"][2], 64)

        x = x4
        rnn_out, conv_out = [], []
        for i, bp in enumerate(P["blocks"]):
            x, h, cc = self._dpr(bp, x, caches["dpr_rnn"][i],
                                 caches["dpr_conv"][i], train)
            rnn_out.append(h)
            conv_out.append(cc)

        dec = P["decoder"]
        y = self._usconv(dec["up1"], torch.cat([x, x4], dim=-1), 32)
        y = self._usconv(dec["up2"], torch.cat([y, x3], dim=-1), 64)
        y = self._usconv(dec["up3"], torch.cat([y, x2], dim=-1), 128)
        dcache = caches["dec"]
        if dcache is None:
            dcache = y.new_zeros(y.shape[0], 1, *y.shape[2:])
        y = torch.cat([dcache, y], dim=1)
        dcache_out = y[:, -1:]
        mc = dec["mask_conv"]
        y = _conv2d_cl(mc["conv1"], y, padding=(0, 1))      # [B, T, 257, 2]
        y = prelu(mc["act"], self._cln_freq(mc["norm"], y))
        y = _conv2d_cl(mc["conv2"], y).transpose(1, 2)      # [B, F, T, 2]
        # LearnableSigmoid over freq (slope [F, 1, 1])
        mask = torch.sigmoid(dec["lsigmoid"]["slope"] * y)

        re = spec[..., 0] * mask[..., 0] - spec[..., 1] * mask[..., 1]
        im = spec[..., 0] * mask[..., 1] + spec[..., 1] * mask[..., 0]
        carry = {"pha": last_pha, "enc": [c2, c3, c4], "dpr_rnn": rnn_out,
                 "dpr_conv": conv_out, "dec": dcache_out}
        return torch.stack([re, im], dim=-1), carry, stats

    # -- offline graph (wav -> wav) -------------------------------------------

    def stft(self, wav: Tensor) -> Tensor:
        return compressed_stft(wav, self.stft_cfg, self.input_compression)

    def forward(self, variables: Params, wav: Tensor, train: bool = False,
                row_mask: tp.Optional[Tensor] = None
                ) -> tp.Tuple[Tensor, Tensor, Params]:
        """wav [B, T] -> (wav_hat [B, T], spec_hat compressed [B, F, T', 2],
        stats). row_mask is taken for a uniform signature: every norm here
        is per item, so a padded row touches no other row."""
        del row_mask
        spec_hat, _, stats = self.model_forward(
            variables["params"], variables["stats"], self.stft(wav),
            train=train)
        wav_hat = compressed_istft(spec_hat, self.stft_cfg,
                                   self.input_compression,
                                   length=wav.shape[-1])
        return wav_hat, spec_hat, stats

    # -- streaming ------------------------------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """{"stft", "istft", "h"} for `batch` streams. h: the last frame's
        phase [B, 1, 257] (float32 in every dtype), the three encoder frame
        caches, each block's time-GRU state [B*32, hdim] (rows batch-major)
        and GLU cache [B, 2, 32, 2C], and the decoder's frame cache."""
        if fused:
            raise ValueError(_NO_PLAN)
        c, f = self.c, self.dpr_freq

        def zeros(*shape, dt=dtype):
            return torch.zeros(*shape, dtype=dt, device=device)

        return {
            "stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
            "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
            "h": {
                "pha": zeros(batch, 1, self.n_freqs, dt=torch.float32),
                "enc": [zeros(batch, 1, 257, c // 4),
                        zeros(batch, 1, 128, c // 2),
                        zeros(batch, 1, 64, c // 4 * 3)],
                "dpr_rnn": [zeros(batch * f, self.hdim)
                            for _ in range(self.n_blocks)],
                "dpr_conv": [zeros(batch, 2, f, 2 * c)
                             for _ in range(self.n_blocks)],
                "dec": zeros(batch, 1, 256, c // 4),
            },
        }

    def streaming_step(self, variables: Params, carry: Params,
                       wav_hop: Tensor) -> tp.Tuple[Params, Tensor]:
        """One hop: wav_hop [B, hop] -> (new_carry, wav_out [B, hop]); the
        output is delayed n_fft - hop samples. Given C hops [B, hop*C] it is
        `streaming_chunk`."""
        return spectral_step(
            self, carry, wav_hop, lambda spec: self.model_forward(
                variables["params"], variables["stats"], spec,
                h0=carry["h"])[:2])

    def streaming_chunk(self, variables: Params, carry: Params,
                        wav_chunk: Tensor) -> tp.Tuple[Params, Tensor]:
        """C hops: wav_chunk [B, hop*C] -> (new_carry, wav_out [B, hop*C]),
        the math of C single-hop steps with the network time-batched over
        the chunk and each time GRU one gru_scan over the C frames from its
        carried state."""
        return self.streaming_step(variables, carry, wav_chunk)

    def stream(self, variables: Params, wav: Tensor,
               chunk_frames: int = 1) -> Tensor:
        """Whole-utterance streaming, one hop per step, or C hops per step
        with chunk_frames=C (the tail cut to a multiple of C).
        wav [B, hop*T] -> [B, hop*T']."""
        return stream_hops(self, variables, wav, chunk_frames, None)

    def fold(self, variables: Params) -> Params:
        """No reparameterization to remove (reference: :476-477)."""
        return variables

    # -- the reference's parameter names (optimizer groups) ---------------------

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """The reference's module names (models/lisennet/model.py), as the
        JAX package maps them."""
        head = path[0]
        if head == "encoder":
            mod, sub = path[1], path[2]
            if mod == "conv_1":
                if sub == "act":
                    return "encoder.conv_1.2.weight"  # PReLU
                return f"encoder.conv_1.{0 if sub == 'conv' else 1}.{path[3]}"
            if sub == "act":
                return f"encoder.{mod}.act.weight"
            return f"encoder.{mod}.{sub}.{path[3]}"
        if head == "blocks":
            i, mod = path[1], path[2]
            prefix = f"blocks.{i}"
            if mod in ("intra_norm", "inter_norm"):
                return f"{prefix}.dp_rnn_attn.{mod}.{path[3]}"
            kind = mod.split("_")[0]
            if mod == "intra_rnn":
                sfx = "_l0" if path[3] == "fwd" else "_l0_reverse"
                return (f"{prefix}.dp_rnn_attn.{kind}_rnn_attn.rnn."
                        f"{path[4]}{sfx}")
            if mod == "inter_rnn":
                return (f"{prefix}.dp_rnn_attn.{kind}_rnn_attn.rnn."
                        f"{path[3]}_l0")
            if mod in ("intra_fc", "inter_fc"):
                return f"{prefix}.dp_rnn_attn.{kind}_rnn_attn.dense.{path[3]}"
            if mod == "glu":
                return f"{prefix}.conv_glu.{path[3]}.{path[4]}"
        if head == "decoder":
            mod = path[1]
            if mod in ("up1", "up2", "up3"):
                sub, leaf = path[2], path[3]
                if sub == "high_conv":
                    return f"decoder.{mod}.high_conv.conv.{leaf}"
                return f"decoder.{mod}.low_conv.{leaf}"
            if mod == "mask_conv":
                idx = {"conv1": 0, "norm": 1, "act": 2, "conv2": 3}[path[2]]
                leaf = path[3] if len(path) > 3 else "weight"
                return f"decoder.mask_conv.{idx}.{leaf}"
            if mod == "lsigmoid":
                return "decoder.lsigmoid.slope"
        raise KeyError(f"unmapped lisennet param path: {path}")

    def fixed_param_paths(self) -> tp.List[tp.Tuple[str, ...]]:
        return []
