"""FSPEN baseline (full-band + sub-band dual-path), inference and streaming,
in PyTorch.

Counterpart of fastenhancer_tpu/models/fspen.py (reference:
models/fspen/model.py, a re-implementation of FSPEN, ICASSP 2024):

* a magnitude sub-band encoder, 5 strided convs over overlapping bin ranges
  (`SUB_ENC`), giving a 32-bin sub-band feature;
* a full-band conv encoder over (re, im) with BatchNorm and ELU;
* feature merge -> N dual-path blocks -> feature split. A block is an intra
  bidirectional GRU over the 32 bins of each frame, then `groups` time
  GRUs, each over its own F/groups bins with its own weights and carried
  state. The inter residual is added twice (`x = concat(...) + 2 * x_in`),
  as the reference does (COMPONENTS.md:69);
* a sub-band decoder of overlapping linears (`SUB_DEC`) and a skip-concat
  ConvTranspose full-band decoder;
* the mask: the full complex mask's direction with magnitude (sub + |full|)
  / 2.

Every convolution sums in float32 (`_conv`): in bfloat16 it runs on the
float32 values and rounds once, as the CPU and XLA do, since cuDNN's bf16
convolution rounds its sum before the bias.

In eval every GRU is the GRU-scan kernel (ops/gru_scan.py): the intra
biGRU two launches (`bigru_fused`, N = T*B rows over the 32 bins), each
group's time GRU one (`gru_fused`, from its carried state), so a block
makes 2 + groups launches (30 a frame or chunk at the recipe's 3 blocks of
8 groups). `fold()` merges BatchNorm into the encoder convs and the decoder
ConvTransposes. The streaming carry is blocks x groups GRU states
[B*F/groups, C], rows batch-major. `streaming_chunk` (and
`stream(chunk_frames=C)`) runs C hops a step, each time GRU one launch over
the C frames.

`forward(train=True, row_mask=...)` is the training graph (JAX fspen.py:
238-335): train-mode BN over the batch (rows with row_mask 0 left out of
the statistics), every GRU nn.gru's or nn.bigru's differentiable loop (no
kernel runs in a train step), the last ConvTranspose and the mask in
float32 as in eval. There is no fused stack plan: the engine runs this
model unfused.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from .. import nn as fnn
from ..functional import (
    STFTConfig,
    compressed_stft,
    compressed_istft,
    init_stft_carry,
    init_istft_carry,
)
from ..ops.gru_scan import bigru_fused, gru_fused
from ..utils.tree import tree_map
from .streaming import spectral_step, stream_hops

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


# float32 copies of bfloat16 convolution parameters, each with the version
# of the tensor it was made from
_WIDE: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _float32(t: Tensor) -> Tensor:
    """t as float32. A bf16 parameter's copy is made once and reused while
    the parameter is unchanged: a stream's or an engine's every step passes
    the same tree, and a copy a step would add two launches to each
    convolution of a host-bound step. Where autograd or a trace must see
    the cast, it is made each call."""
    if (t.dtype == torch.float32 or t.requires_grad or torch.is_inference(t)
            or torch.compiler.is_compiling()):
        return t.float()
    hit = _WIDE.get(t)
    if hit is None or hit[0] != t._version:
        hit = _WIDE[t] = (t._version, t.float())
    return hit[1]


def _conv(fn: tp.Callable[..., Tensor], p: Params, x: Tensor,
          **kwargs: tp.Any) -> Tensor:
    """fn (`nn.conv1d_cl` or `conv_transpose1d_cl`) with float32 sums: a
    bfloat16 convolution runs on its float32 values and is rounded to bf16
    once, after the bias, as the CPU and XLA compute it. cuDNN's bf16
    convolution rounds its sum to bf16 before it adds the bias, and FSPEN's
    mask takes the full-band mask's direction, which that rounding turns
    far where a bin's sum nearly cancels its bias (on the H100,
    `chip_smoke.py` phase 19 holds both forms against the CPU's)."""
    if x.dtype != torch.bfloat16:
        return fn(p, x, **kwargs)
    return fn({k: _float32(v) for k, v in p.items()}, x.float(),
              **kwargs).to(torch.bfloat16)


# sub-band encoder geometry (reference :59-66):
# (input slice start, end, left pad, right pad, kernel, stride)
SUB_ENC = [
    (0, 17, 1, 0, 4, 2),     # -> 8 bins
    (13, 35, 0, 0, 7, 3),    # -> 6
    (30, 66, 0, 0, 11, 5),   # -> 6
    (61, 131, 0, 0, 20, 10),  # -> 6
    (122, 257, 0, 5, 40, 20),  # -> 6
]
# sub-band decoder geometry (reference :87-95):
# (feature slice start, end, pad rows, out per row, trim start, trim end)
SUB_DEC = [
    (0, 8, 0, 2, 0, 16),
    (8, 14, 0, 3, 1, 17),
    (13, 21, 0, 5, 4, 36),
    (19, 27, 0, 10, 8, 72),
    (25, 32, 1, 20, 16, 145),
]

_NO_PLAN = ("FSPEN has no fused stack plan: serve it unfused "
            "(StreamingEngine(fused=False))")


@dataclasses.dataclass
class DPEConfig:
    num_blocks: int = 3
    channels: int = 16
    freq: int = 32
    groups: int = 8
    norm: str = "LayerNorm-FreqChannels"


class Model(torch.nn.Module):
    """FSPEN. Takes the reference's `model_kwargs` unchanged
    (configs/others/fspen.yaml). The module holds the configuration only;
    weights live in the variables tree that `init` returns."""

    def __init__(
        self,
        channels: tp.Sequence[int] = (4, 16, 32),
        kernel_size: tp.Sequence[int] = (6, 8, 6),
        stride: tp.Sequence[int] = (2, 2, 2),
        dpe_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        n_fft: int = 512,
        hop_size: int = 256,
        win_size: int = 512,
        window: str = "hann",
        input_compression: float = 0.3,
        stft_method: str = "fft",
    ):
        super().__init__()
        if n_fft != 512:
            raise ValueError("the FSPEN sub-band geometry needs n_fft=512")
        self.channels = list(channels)
        self.kernel_size = list(kernel_size)
        self.stride = list(stride)
        self.dpe = DPEConfig(**(dpe_kwargs or {}))
        if self.dpe.freq % self.dpe.groups:
            raise ValueError(f"freq {self.dpe.freq} is not a multiple of "
                             f"groups {self.dpe.groups}")
        self.n_fft = n_fft
        self.hop_size = hop_size
        self.input_compression = input_compression
        self.stft_cfg = STFTConfig(n_fft=n_fft, hop_size=hop_size,
                                   win_size=win_size, win_type=window,
                                   method=stft_method)
        self.num_blocks = self.dpe.num_blocks
        # row inclusion mask [B] of a train forward's BN statistics, held
        # for the duration of forward(train=True, row_mask=...)
        self._row_mask: tp.Optional[Tensor] = None

    # -- init -----------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """Fresh {"params", "stats"} on `device`, with the JAX init's tree
        and distributions (torch-default uniform inits, identity
        BatchNorm). Values are drawn on the CPU from `generator`."""
        dpe, g, dev = self.dpe, generator, torch.device(device)
        c_out = self.channels[-1]
        params: Params = {}
        stats: Params = {}
        params["subband_encoder"] = [
            fnn.torch_conv1d_init(g, c_out, 1, k, True, dev)
            for (_, _, _, _, k, _) in SUB_ENC]
        params["subband_decoder"] = [
            fnn.torch_linear_init(g, out, c_out * 2, True, dev)
            for (_, _, _, out, _, _) in SUB_DEC]

        params["fullband_encoder"], stats["fullband_encoder"] = [], []
        for i, (k, c) in enumerate(zip(self.kernel_size, self.channels)):
            cin = 2 if i == 0 else self.channels[i - 1]
            bn_p, bn_s = fnn.init_batch_norm(c, dev)
            params["fullband_encoder"].append({
                "conv": fnn.torch_conv1d_init(g, c, cin, k, False, dev),
                "bn": bn_p})
            stats["fullband_encoder"].append({"bn": bn_s})
        params["fullband_encoder_post"] = fnn.torch_conv1d_init(
            g, c_out, c_out, 1, False, dev)

        params["feature_merge"] = {
            "lin": fnn.torch_linear_init(g, dpe.freq, 64, False, dev),
            "conv": fnn.torch_conv1d_init(g, dpe.channels, c_out, 1, True,
                                          dev),
        }

        params["dpe_blocks"], stats["dpe_blocks"] = [], []
        ch = dpe.channels
        for _ in range(dpe.num_blocks):
            params["dpe_blocks"].append({
                "intra_rnn": fnn.init_bigru(g, ch, ch, dev),
                "intra_fc": fnn.torch_linear_init(g, ch, 2 * ch, True, dev),
                "intra_ln": {
                    "weight": torch.ones(dpe.freq, ch, device=dev),
                    "bias": torch.zeros(dpe.freq, ch, device=dev),
                },
                "inter_rnn": [fnn.init_gru(g, ch, ch, dev)
                              for _ in range(dpe.groups)],
                "inter_fc": [fnn.torch_linear_init(g, ch, ch, True, dev)
                             for _ in range(dpe.groups)],
            })
            stats["dpe_blocks"].append({})

        params["feature_split"] = {
            "conv": fnn.torch_conv1d_init(g, c_out, dpe.channels, 1, True,
                                          dev),
            "lin": fnn.torch_linear_init(g, 64, dpe.freq, False, dev),
        }

        params["fullband_decoder"], stats["fullband_decoder"] = [], []
        for i in range(len(self.channels) - 1, -1, -1):
            cin = self.channels[i]
            cout = 2 if i == 0 else self.channels[i - 1]
            unit: Params = {
                "conv1": fnn.torch_conv1d_init(g, cin, 2 * cin, 1, False,
                                               dev),
                "convt": fnn.torch_convtranspose1d_init(
                    g, cin, cout, self.kernel_size[i], i == 0, dev)}
            st: Params = {}
            if i != 0:
                unit["bn"], st["bn"] = fnn.init_batch_norm(cout, dev)
            params["fullband_decoder"].append(unit)
            stats["fullband_decoder"].append(st)
        return {"params": params, "stats": stats}

    # -- pieces ---------------------------------------------------------------

    @staticmethod
    def _subband_encode(params: tp.Sequence[Params], mag: Tensor) -> Tensor:
        """mag [N, F=257] -> [N, 32, C] (channels-last)."""
        outs = []
        for p, (s, e, pl, pr, _, st) in zip(params, SUB_ENC):
            x = F.pad(mag[:, s:e], (pl, pr)) if pl or pr else mag[:, s:e]
            outs.append(F.relu(_conv(fnn.conv1d_cl, p, x[:, :, None],
                                     stride=st)))
        return torch.cat(outs, dim=1)

    @staticmethod
    def _subband_decode(params: tp.Sequence[Params], x: Tensor) -> Tensor:
        """x [N, 32, 2C] -> [N, 257], the sub-band magnitude mask."""
        n = x.shape[0]
        outs = []
        for p, (s, e, pad, _, ts, te) in zip(params, SUB_DEC):
            xi = F.pad(x[:, s:e], (0, 0, 0, pad)) if pad else x[:, s:e]
            y = F.relu(fnn.linear(p, xi))
            outs.append(y.reshape(n, -1)[:, ts:te])
        return torch.cat(outs, dim=1)

    def _dpe_block(self, p: Params, x: Tensor,
                   h0: tp.Optional[tp.Sequence[Tensor]], train: bool = False
                   ) -> tp.Tuple[Tensor, tp.List[Tensor]]:
        """x [T, B, F, C]; h0: the groups' carried states or None (zeros)
        -> (x, the groups' h_T). 2 + groups gru_scan launches in eval;
        nn.bigru's and nn.gru's loops in train."""
        t, b, f, c = x.shape
        bigru = fnn.bigru if train else bigru_fused
        gru = fnn.gru if train else gru_fused
        # intra: a biGRU over the bins of each frame, then LayerNorm([F, C])
        x_in = x
        y = bigru(p["intra_rnn"], x.reshape(t * b, f, c).transpose(0, 1))
        y = fnn.linear(p["intra_fc"],
                       y.transpose(0, 1).reshape(t, b, f, 2 * c))
        yf = y.float()
        mean = yf.mean(dim=(-2, -1), keepdim=True)
        var = (yf - mean).square().mean(dim=(-2, -1), keepdim=True)
        y = ((yf - mean) * torch.rsqrt(var + 1e-5)).to(y.dtype)
        x = y * p["intra_ln"]["weight"] + p["intra_ln"]["bias"] + x_in

        # inter: a time GRU per group of F/groups bins, from its carry
        x_in = x
        fg = f // self.dpe.groups
        outs, h_out = [], []
        for gi, (rnn, fc) in enumerate(zip(p["inter_rnn"], p["inter_fc"])):
            xg = x[:, :, gi * fg:(gi + 1) * fg].reshape(t, b * fg, c)
            yg, h_t = gru(rnn, xg, None if h0 is None else h0[gi])
            h_out.append(h_t)
            outs.append(fnn.linear(fc, yg).reshape(t, b, fg, c))
        # the reference adds the inter residual twice (InterRNNPathExtension
        # :139 and DPE.forward :188); checkpoints were trained with it
        return torch.cat(outs, dim=2) + 2.0 * x_in, h_out

    # -- core network ---------------------------------------------------------

    def model_forward(self, params: Params, stats: Params, spec: Tensor,
                      h0: tp.Optional[tp.List[tp.List[Tensor]]] = None,
                      train: bool = False
                      ) -> tp.Tuple[Tensor, tp.List[tp.List[Tensor]], Params]:
        """Compressed spec [B, F=257, T, 2] -> (spec_hat, each block's
        groups' h_T, stats). train=True runs every BN in train mode and
        returns their new statistics (a new tree)."""
        dpe = self.dpe
        b, f0, t, _ = spec.shape
        new_stats = tree_map(lambda a: a, stats) if train else None
        bw = (None if self._row_mask is None else
              self._row_mask.float().repeat_interleave(t)[:, None, None])

        def bn(p: Params, s: Params, group: str, i: int, x: Tensor
               ) -> Tensor:
            x, st = fnn.batch_norm(p["bn"], s["bn"], x, train=train,
                                   weight=bw)
            if train:
                new_stats[group][i] = {"bn": st}
            return x

        x = spec.permute(0, 2, 1, 3).reshape(b * t, f0, 2)   # [BT, F, 2]
        mag = x.square().sum(dim=2).sqrt()                   # [BT, F]
        x_sub1 = self._subband_encode(params["subband_encoder"], mag)

        enc_out = []
        for i, (p, s) in enumerate(zip(params["fullband_encoder"],
                                       stats["fullband_encoder"])):
            k, st = self.kernel_size[i], self.stride[i]
            x = _conv(fnn.conv1d_cl, p["conv"], x, stride=st,
                      padding=(k - st) // 2)
            if s.get("bn") is not None:  # folded models have BN fused away
                x = bn(p, s, "fullband_encoder", i, x)
            x = F.elu(x)
            enc_out.append(x)
        # [BT, 32, C]
        x = _conv(fnn.conv1d_cl, params["fullband_encoder_post"], x)

        # feature merge: concat on freq -> linear over freq -> 1x1 conv
        x = torch.cat([x, x_sub1], dim=1)                    # [BT, 64, C]
        x = F.elu(torch.einsum("oF,nFc->noc",
                               params["feature_merge"]["lin"]["weight"], x))
        x = _conv(fnn.conv1d_cl, params["feature_merge"]["conv"], x)

        xb = x.reshape(b, t, dpe.freq, dpe.channels).transpose(0, 1)
        carry_out = []
        for i, p in enumerate(params["dpe_blocks"]):
            xb, h_out = self._dpe_block(p, xb, None if h0 is None else h0[i],
                                        train)
            carry_out.append(h_out)
        x = xb.transpose(0, 1).reshape(b * t, dpe.freq, dpe.channels)

        # feature split: 1x1 conv -> linear freq -> 64 -> ELU
        x = _conv(fnn.conv1d_cl, params["feature_split"]["conv"], x)
        x = F.elu(torch.einsum("oF,nFc->noc",
                               params["feature_split"]["lin"]["weight"], x))
        x_full, x_sub2 = x[:, :32], x[:, 32:]

        mask_sub = self._subband_decode(params["subband_decoder"],
                                        torch.cat([x_sub1, x_sub2], dim=2))
        mask_sub = mask_sub.reshape(b, t, f0).transpose(1, 2)[..., None]

        x = x_full
        for i, (p, s) in enumerate(zip(params["fullband_decoder"],
                                       stats["fullband_decoder"])):
            ci = len(self.channels) - 1 - i
            k, st = self.kernel_size[ci], self.stride[ci]
            x = _conv(fnn.conv1d_cl, p["conv1"],
                      torch.cat([x, enc_out.pop()], dim=2))
            if ci == 0:  # the last unit's ConvTranspose makes the mask
                break
            x = _conv(fnn.conv_transpose1d_cl, p["convt"], x, stride=st,
                      padding=(k - st) // 2)
            if p.get("bn") is not None and s.get("bn") is not None:
                x = bn(p, s, "fullband_decoder", i, x)
            x = F.elu(x)  # after the BN, or the convt it was folded into
        return (self._mask(p["convt"], x, spec, mask_sub), carry_out,
                stats if new_stats is None else new_stats)

    def _mask(self, convt: Params, x: Tensor, spec: Tensor,
              mask_sub: Tensor) -> Tensor:
        """The last ConvTranspose (x [BT, 128, C0] -> the full-band complex
        mask) and the mask: the full mask's direction with magnitude
        (sub + |full|) / 2, applied to spec [B, F, T, 2]; float32 inside,
        spec's dtype out. In bfloat16 cuDNN rounds a ConvTranspose's sum
        before adding its bias, which can cancel both channels of a bin to
        exactly 0, and the direction divides by that magnitude (a NaN on
        the H100 at 256 streams, chip_smoke.py phase 19); in float32 the
        sum and the bias stay together."""
        b, f0, t, _ = spec.shape
        k, st = self.kernel_size[0], self.stride[0]
        mask_full = fnn.conv_transpose1d_cl(
            {n: _float32(a) for n, a in convt.items()}, x.float(), stride=st,
            padding=(k - st) // 2, output_padding=1)
        mask_full = mask_full.reshape(b, t, f0, 2).transpose(1, 2)
        sf = spec.float()
        re = sf[..., 0] * mask_full[..., 0] - sf[..., 1] * mask_full[..., 1]
        im = sf[..., 0] * mask_full[..., 1] + sf[..., 1] * mask_full[..., 0]
        out_full = torch.stack([re, im], dim=-1)
        mask_full_mag = mask_full.square().sum(dim=-1, keepdim=True).sqrt()
        mask_mag = (mask_sub.float() + mask_full_mag) * 0.5
        return (out_full / mask_full_mag * mask_mag).to(spec.dtype)

    # -- offline graph (wav -> wav) -------------------------------------------

    def stft(self, wav: Tensor) -> Tensor:
        return compressed_stft(wav, self.stft_cfg, self.input_compression)

    def forward(self, variables: Params, wav: Tensor, train: bool = False,
                row_mask: tp.Optional[Tensor] = None
                ) -> tp.Tuple[Tensor, Tensor, Params]:
        """wav [B, T] -> (wav_hat [B, T], spec_hat compressed [B, F, T', 2],
        stats; the new BN statistics when train=True). row_mask [B] (1 real,
        0 zero-padded) leaves padded rows out of the train-mode BN
        statistics; it is held on self for the call."""
        self._row_mask = row_mask if train else None
        try:
            spec_hat, _, stats = self.model_forward(
                variables["params"], variables["stats"], self.stft(wav),
                train=train)
        finally:
            self._row_mask = None
        wav_hat = compressed_istft(spec_hat, self.stft_cfg,
                                   self.input_compression,
                                   length=wav.shape[-1])
        return wav_hat, spec_hat, stats

    # -- streaming ------------------------------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """{"stft", "istft", "h"} for `batch` streams; h holds each block's
        groups' GRU states [B*F/groups, C], rows batch-major."""
        if fused:
            raise ValueError(_NO_PLAN)
        dpe = self.dpe
        rows = batch * (dpe.freq // dpe.groups)
        return {
            "stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
            "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
            "h": [[torch.zeros(rows, dpe.channels, dtype=dtype, device=device)
                   for _ in range(dpe.groups)]
                  for _ in range(dpe.num_blocks)],
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

    # -- deploy-time folding --------------------------------------------------

    def fold(self, variables: Params) -> Params:
        """Merge BN into the encoder convs and the decoder ConvTransposes
        (reference: :299-343)."""
        params, stats = variables["params"], variables["stats"]
        eps = 1e-5
        out = dict(params)
        new_enc = []
        for p, s in zip(params["fullband_encoder"], stats["fullband_encoder"]):
            g = p["bn"]["weight"] / torch.sqrt(s["bn"]["var"] + eps)
            new_enc.append({"conv": {
                "weight": p["conv"]["weight"] * g[:, None, None],
                "bias": p["bn"]["bias"] - s["bn"]["mean"] * g}, "bn": None})
        out["fullband_encoder"] = new_enc
        new_dec = []
        for p, s in zip(params["fullband_decoder"], stats["fullband_decoder"]):
            unit = dict(p)
            if p.get("bn") is not None and "bn" in s:
                g = p["bn"]["weight"] / torch.sqrt(s["bn"]["var"] + eps)
                # convT weight [Cin, Cout, k]: scale output channels
                unit["convt"] = {
                    "weight": p["convt"]["weight"] * g[None, :, None],
                    "bias": p["bn"]["bias"] - s["bn"]["mean"] * g}
                unit["bn"] = None
            new_dec.append(unit)
        out["fullband_decoder"] = new_dec
        folded_stats = {"fullband_encoder": [{} for _ in self.channels],
                        "fullband_decoder": [{} for _ in self.channels],
                        "dpe_blocks": [{} for _ in range(self.num_blocks)]}
        return {"params": out, "stats": folded_stats}

    # -- the reference's parameter names (optimizer groups) ---------------------

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """The reference's module names (models/fspen/model.py), as the
        JAX package maps them."""
        head = path[0]
        if head == "subband_encoder":
            return f"subband_encoder.conv{int(path[1]) + 1}.0.{path[2]}"
        if head == "subband_decoder":
            return f"subband_decoder.lin{int(path[1]) + 1}.0.{path[2]}"
        if head == "fullband_encoder":
            i, mod, leaf = path[1], path[2], path[3]
            return f"fullband_encoder.{i}.{0 if mod == 'conv' else 1}.{leaf}"
        if head == "fullband_encoder_post":
            return f"fullband_encoder_post.{path[1]}"
        if head in ("feature_merge", "feature_split"):
            order = ({"lin": 0, "conv": 2} if head == "feature_merge"
                     else {"conv": 0, "lin": 1})
            return f"{head}.{order[path[1]]}.{path[2]}"
        if head == "dpe_blocks":
            i, mod = path[1], path[2]
            prefix = f"dpe_blocks.{i}"
            if mod == "intra_rnn":
                sfx = "_l0" if path[3] == "fwd" else "_l0_reverse"
                return f"{prefix}.intra_rnn.{path[4]}{sfx}"
            if mod in ("intra_fc", "intra_ln"):
                return f"{prefix}.{mod}.{path[3]}"
            if mod == "inter_rnn":
                return f"{prefix}.inter_rnn.inter_rnn.{path[3]}.{path[4]}_l0"
            if mod == "inter_fc":
                return f"{prefix}.inter_rnn.inter_fc.{path[3]}.{path[4]}"
        if head == "fullband_decoder":
            i, mod, leaf = path[1], path[2], path[3]
            idx = {"conv1": 0, "convt": 1, "bn": 2}[mod]
            return f"fullband_decoder.{i}.{idx}.{leaf}"
        raise KeyError(f"unmapped fspen param path: {path}")

    def fixed_param_paths(self) -> tp.List[tp.Tuple[str, ...]]:
        return []
