"""BSRNN baseline (band-split RNN), inference and streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/bsrnn.py (reference:
models/bsrnn/model.py, a re-implementation of Yu et al., "High fidelity
speech enhancement with band-split RNN", Interspeech 2023):

* 31-subband BandSplit: per-band BN over the (re, im)-interleaved bins and
  a 1x1 conv to C channels;
* num_layers x (pre-BN -> time LSTM C->2C -> fc -> +skip; pre-BN ->
  bidirectional band LSTM C->2C per direction -> fc 4C->C -> +skip);
* per-band mask and residual GLU MLPs;
* the full 257-bin compressed spectrum (no last-bin drop), complex mask
  multiply plus residual add.

The band split and mask decoder run as five batched products, one per run
of equal-width subbands. `fold()` fuses the pre-norms into the following
conv and LSTM input weights; folded and unfolded trees run through the same
code. Streaming carries each layer's time-LSTM (h, c): a list of (h, c)
[B*F', 2C] (rows batch-major), or stacked [L, 2, F', B, 2C] (rows
frequency-major) for `streaming_step_fused`, which runs the layer stack as
one CUDA kernel per frame (ops/bsrnn_stack.py). `streaming_chunk` (and
`stream(chunk_frames=C)`) runs C hops a step, the network time-batched over
the chunk and each time LSTM over the C frames from its carried (h, c).

`forward(train=True, row_mask=...)` is the training graph (JAX bsrnn.py:
226-338): the band split and the mask decoder in the grouped form that
eval runs (each band's BN statistics its own), every BN in train mode over
the batch (rows with row_mask 0 left out of the
statistics), the LSTMs nn.lstm's and nn.bilstm's loops; it returns the new
statistics.
"""
from __future__ import annotations

import typing as tp

import torch

from .. import nn as fnn
from ..functional import (
    STFTConfig,
    compressed_stft,
    compressed_istft,
    init_stft_carry,
    init_istft_carry,
)
from ..ops.bsrnn_stack import bsrnn_stack_step, plan_band_stack
from ..utils.tree import tree_map
from .streaming import spectral_step, stream_hops

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

SUBBANDS_512 = [2, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
                8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
                16, 16, 16, 16, 16, 16, 16, 17]  # sum == 257

class Model(torch.nn.Module):
    """BSRNN. Takes the reference's `model_kwargs` unchanged
    (configs/others/bsrnn_*.yaml). The module holds the configuration only;
    weights live in the variables tree that `init` returns."""

    # no spec2spec form: the fused step is exported as wav2wav
    # (scripts/export.py)
    spec2spec_fused = False

    def __init__(
        self,
        num_channels: int = 16,
        num_layers: int = 6,
        bias: bool = True,
        affine: bool = True,
        n_fft: int = 512,
        hop_size: int = 256,
        win_size: int = 512,
        window: str = "hann",
        input_compression: float = 0.3,
        stft_method: str = "fft",
    ):
        super().__init__()
        if n_fft != 512:
            raise ValueError("the reference BandSplit supports n_fft=512 only")
        self.subbands = list(SUBBANDS_512)
        self.channels = num_channels
        self.num_layers = num_layers
        self.bias = bias
        self.affine = affine
        self.n_fft = n_fft
        self.hop_size = hop_size
        self.input_compression = input_compression
        self.stft_cfg = STFTConfig(n_fft=n_fft, hop_size=hop_size,
                                   win_size=win_size, win_type=window,
                                   method=stft_method)
        self.n_bands = len(self.subbands)
        self._groups = self._band_groups()
        # row inclusion mask [B] of a train forward's BN statistics, held
        # for the duration of forward(train=True, row_mask=...)
        self._row_mask: tp.Optional[Tensor] = None

    # -- init -----------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """Fresh {"params", "stats"} on `device`, with the JAX init's tree
        and distributions (torch-default uniform inits, identity
        BatchNorm). Values are drawn on the CPU from `generator`."""
        c, g, dev = self.channels, generator, torch.device(device)
        hdim = 2 * c
        params: Params = {"band_split": [], "layers": [], "mask_decoder": []}
        stats: Params = {"band_split": [], "layers": [], "mask_decoder": []}
        for sub in self.subbands:
            bn_p, bn_s = fnn.init_batch_norm(sub * 2, dev, affine=self.affine)
            params["band_split"].append({
                "norm": bn_p,
                "fc": fnn.torch_conv1d_init(g, c, sub * 2, 1, self.bias, dev)})
            stats["band_split"].append({"norm": bn_s})
        for _ in range(self.num_layers):
            nt_p, nt_s = fnn.init_batch_norm(c, dev, affine=self.affine)
            nf_p, nf_s = fnn.init_batch_norm(c, dev, affine=self.affine)
            params["layers"].append({
                "norm_time": nt_p,
                "rnn_time": fnn.init_lstm(g, c, hdim, dev),
                "fc_time": fnn.torch_linear_init(g, c, hdim, self.bias, dev),
                "norm_freq": nf_p,
                "rnn_freq": fnn.init_bilstm(g, c, hdim, dev),
                "fc_freq": fnn.torch_linear_init(g, c, 2 * hdim, self.bias,
                                                 dev),
            })
            stats["layers"].append({"norm_time": nt_s, "norm_freq": nf_s})
        for sub in self.subbands:
            entry: Params = {}
            entry_s: Params = {}
            for which in ("mask", "residual"):
                bn_p, bn_s = fnn.init_batch_norm(c, dev, affine=self.bias)
                entry[which] = {
                    "norm": bn_p,
                    "conv1": fnn.torch_conv1d_init(g, 4 * c, c, 1, True, dev),
                    "conv2": fnn.torch_conv1d_init(g, sub * 4, 4 * c, 1, True,
                                                   dev),
                }
                entry_s[which] = {"norm": bn_s}
            params["mask_decoder"].append(entry)
            stats["mask_decoder"].append(entry_s)
        return {"params": params, "stats": stats}

    # -- pieces ---------------------------------------------------------------

    def _band_groups(self) -> tp.List[tp.Tuple[int, int, int, int]]:
        """Consecutive runs of equal-width subbands: (band_idx0, n_bands,
        sub_width, bin_start). The 512-FFT layout gives 5 groups (widths
        2/3/8/16/17), so the per-band work runs as 5 batched products."""
        groups = []
        i = bin0 = 0
        while i < self.n_bands:
            sub = self.subbands[i]
            j = i
            while j < self.n_bands and self.subbands[j] == sub:
                j += 1
            groups.append((i, j - i, sub, bin0))
            bin0 += (j - i) * sub
            i = j
        return groups

    def _bn_bands(self, ps: tp.Sequence[Params], ss: tp.Sequence[Params],
                  x: Tensor, train: bool, key: tp.Optional[str] = None
                  ) -> tp.Tuple[Tensor, tp.Optional[tp.List[Params]]]:
        """BN of a [B, T, g, ch] stack of g bands, each with its own
        parameters and statistics: one batch_norm over the [B, T, g*ch]
        view, whose channels are the bands' concatenated channels (train
        mode reduces over B and T, so each band gets its own statistics,
        the row mask's rows left out). `key` indexes into nested {mask,
        residual} entries. Returns y and, in train mode, each band's new
        {"norm": stats} (None in eval)."""
        pick = (lambda e: e) if key is None else (lambda e: e[key])
        b, t, g, ch = x.shape

        def cat(trees: tp.Sequence[Params], k: str) -> Tensor:
            return torch.cat([pick(e)["norm"][k] for e in trees])

        p_cat = (None if pick(ps[0])["norm"] is None else
                 {k: cat(ps, k) for k in ("weight", "bias")})
        s_cat = {k: cat(ss, k) for k in ("mean", "var")}
        bw = None if self._row_mask is None else \
            self._row_mask.float()[:, None, None]
        y, st = fnn.batch_norm(p_cat, s_cat, x.reshape(b, t, g * ch),
                               train=train, weight=bw)
        per_band = None if not train else [
            {"norm": {"mean": m, "var": v}}
            for m, v in zip(st["mean"].split(ch), st["var"].split(ch))]
        return y.reshape(b, t, g, ch), per_band

    def _band_split(self, params: tp.Sequence[Params],
                    stats: tp.Sequence[Params], spec: Tensor,
                    train: bool = False
                    ) -> tp.Tuple[Tensor, tp.List[Params]]:
        """spec [B, F, T, 2] -> ([T, B, F', C], each band's statistics, new
        in train mode); one batched product per group of equal-width
        subbands, whose channels are the (re, im)-interleaved bins of the
        band."""
        b, _, t, _ = spec.shape
        outs, new_stats = [], []
        for i0, g, sub, bin0 in self._groups:
            x = spec[:, bin0:bin0 + g * sub]                # [B, g*sub, T, 2]
            x = (x.reshape(b, g, sub, t, 2).permute(0, 3, 1, 2, 4)
                 .reshape(b, t, g, sub * 2))                # [B, T, g, sub*2]
            ps, ss = params[i0:i0 + g], stats[i0:i0 + g]
            st = None
            if ss[0].get("norm") is not None:               # folded: no norms
                x, st = self._bn_bands(ps, ss, x, train)
            new_stats += ss if st is None else st
            wfc = torch.stack([p["fc"]["weight"][:, :, 0] for p in ps])
            x = torch.einsum("btgs,gcs->btgc", x, wfc)      # [B, T, g, C]
            if "bias" in ps[0]["fc"]:
                x = x + torch.stack([p["fc"]["bias"] for p in ps])
            outs.append(x)
        return torch.cat(outs, dim=2).transpose(0, 1), new_stats

    def _mask_decoder(self, params: tp.Sequence[Params],
                      stats: tp.Sequence[Params], x: Tensor,
                      train: bool = False
                      ) -> tp.Tuple[Tensor, Tensor, tp.List[Params]]:
        """x [B, F', C, T] -> (mask, residual, each [B, F, T, 2]; each
        band's statistics, new in train mode). The C->4C conv1 batches over
        all bands, the 4C->sub*4 conv2 and its GLU over each group of
        equal-width subbands."""
        b, _, _, t = x.shape
        xall = x.permute(0, 3, 1, 2)                        # [B, T, F', C]
        outs = {}
        new_stats: tp.List[Params] = [{} for _ in params]
        for which in ("mask", "residual"):
            y = xall
            if stats[0].get(which, {}).get("norm") is not None:
                y, st = self._bn_bands(params, stats, y, train, key=which)
                for e, s in zip(new_stats, st or []):
                    e[which] = s
            w1 = torch.stack([p[which]["conv1"]["weight"][:, :, 0]
                              for p in params])             # [F', 4C, C]
            b1 = torch.stack([p[which]["conv1"]["bias"] for p in params])
            y = torch.tanh(torch.einsum("btfc,fdc->btfd", y, w1) + b1)
            pieces = []
            for i0, g, sub, _ in self._groups:
                ps = params[i0:i0 + g]
                w2 = torch.stack([p[which]["conv2"]["weight"][:, :, 0]
                                  for p in ps])             # [g, sub*4, 4C]
                b2 = torch.stack([p[which]["conv2"]["bias"] for p in ps])
                z = torch.einsum("btgd,gsd->btgs", y[:, :, i0:i0 + g],
                                 w2) + b2
                a, gate = z.chunk(2, dim=-1)                # torch GLU(dim=1)
                pieces.append((a * torch.sigmoid(gate))     # [B, T, g, sub*2]
                              .reshape(b, t, g * sub, 2))
            outs[which] = torch.cat(pieces, dim=2).transpose(1, 2)
        return outs["mask"], outs["residual"], (new_stats if train
                                                else list(stats))

    @staticmethod
    def _apply_mask(spec: Tensor, mask: Tensor, res: Tensor) -> Tensor:
        re = spec[..., 0] * mask[..., 0] - spec[..., 1] * mask[..., 1]
        im = spec[..., 0] * mask[..., 1] + spec[..., 1] * mask[..., 0]
        return torch.stack([re, im], dim=-1) + res

    # -- core network -----------------------------------------------------------

    def model_forward(self, params: Params, stats: Params, spec: Tensor,
                      h0: tp.Optional[tp.List[tp.Tuple[Tensor, Tensor]]] = None,
                      train: bool = False
                      ) -> tp.Tuple[Tensor, tp.List[tp.Tuple[Tensor, Tensor]],
                                    Params]:
        """Compressed spec [B, F, T, 2] -> (spec_hat, each layer's (h_T,
        c_T), stats). train=True runs every BN in train mode and returns
        their new statistics (a new tree)."""
        new_stats = tree_map(lambda a: a, stats) if train else None
        x, band_stats = self._band_split(params["band_split"],
                                         stats["band_split"], spec, train)
        if train:
            new_stats["band_split"] = band_stats
        t, b, f, c = x.shape
        bw = None if self._row_mask is None else \
            self._row_mask.float()[None, :, None, None]

        def norm(p: Params, s: Params, key: str, i: int, x: Tensor
                 ) -> Tensor:
            if s.get(key) is None:  # folded: merged into the LSTM
                return x
            y, st = fnn.batch_norm(p[key], s[key], x, train=train, weight=bw)
            if train:
                new_stats["layers"][i][key] = st
            return y

        carry_out = []
        for i, (p, s) in enumerate(zip(params["layers"], stats["layers"])):
            skip = x
            y = norm(p, s, "norm_time", i, x)
            y, hc = fnn.lstm(p["rnn_time"], y.reshape(t, b * f, c),
                             None if h0 is None else h0[i])
            carry_out.append(hc)
            x = fnn.linear(p["fc_time"], y).reshape(t, b, f, c) + skip

            skip = x
            y = norm(p, s, "norm_freq", i, x)
            y = fnn.bilstm(p["rnn_freq"],
                           y.reshape(t * b, f, c).transpose(0, 1))
            y = y.transpose(0, 1).reshape(t, b, f, 4 * c)
            x = fnn.linear(p["fc_freq"], y) + skip

        x = x.permute(1, 2, 3, 0)                           # [B, F', C, T]
        mask, res, dec_stats = self._mask_decoder(
            params["mask_decoder"], stats["mask_decoder"], x, train)
        if train:
            new_stats["mask_decoder"] = dec_stats
        return (self._apply_mask(spec, mask, res), carry_out,
                stats if new_stats is None else new_stats)

    # -- offline graph (wav -> wav) ---------------------------------------------

    def stft(self, wav: Tensor) -> Tensor:
        return compressed_stft(wav, self.stft_cfg, self.input_compression)

    def forward(self, variables: Params, wav: Tensor, train: bool = False,
                row_mask: tp.Optional[Tensor] = None
                ) -> tp.Tuple[Tensor, Tensor, Params]:
        """wav [B, T] -> (wav_hat [B, T], spec_hat compressed [B, F, T', 2],
        stats; the new BN statistics when train=True). row_mask [B] (1 real,
        0 zero-padded) leaves padded rows out of the train-mode BN
        statistics; it is held on self for the call."""
        params, stats = variables["params"], variables["stats"]
        self._row_mask = row_mask if train else None
        try:
            spec = self.stft(wav)
            spec_hat, _, stats = self.model_forward(params, stats, spec,
                                                    train=train)
        finally:
            self._row_mask = None
        wav_hat = compressed_istft(spec_hat, self.stft_cfg,
                                   self.input_compression,
                                   length=wav.shape[-1])
        return wav_hat, spec_hat, stats

    # -- streaming ----------------------------------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """{"stft", "istft", "h"} for `batch` streams. h is a list of
        per-layer (h, c) [B*F', 2C] (rows batch-major), or with fused=True
        the kernel's stacked frequency-major [L, 2, F', B, 2C]."""
        hdim = 2 * self.channels
        if fused:
            h = torch.zeros(self.num_layers, 2, self.n_bands, batch, hdim,
                            dtype=dtype, device=device)
        else:
            h = [tuple(torch.zeros(batch * self.n_bands, hdim, dtype=dtype,
                                   device=device) for _ in range(2))
                 for _ in range(self.num_layers)]
        return {"stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
                "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
                "h": h}

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
        the chunk. The carry is init_streaming_carry()'s (fused=False)."""
        return self.streaming_step(variables, carry, wav_chunk)

    # -- fused-stack streaming (CUDA kernel) -------------------------------------

    def build_stack_plan(self, variables: Params,
                         dtype: tp.Optional[torch.dtype] = None) -> Params:
        """Pack FOLDED layer params for the band-stack kernel
        (ops/bsrnn_stack.py); the pre-norm BNs must already be fused into
        the LSTM input weights."""
        layers = variables["params"]["layers"]
        if layers and layers[0].get("norm_time") is not None:
            raise ValueError("build_stack_plan expects fold() output")
        return plan_band_stack(layers, dtype)

    def streaming_step_fused(self, variables: Params, plan: Params,
                             carry: Params, wav_hop: Tensor
                             ) -> tp.Tuple[Params, Tensor]:
        """streaming_step with the whole layer stack as one kernel launch;
        same math as streaming_step on folded variables. carry["h"] is the
        stacked frequency-major layout (init_streaming_carry(fused=True))."""
        params, stats = variables["params"], variables["stats"]

        def network(spec):
            x, _ = self._band_split(params["band_split"],
                                    stats["band_split"], spec)  # [1,B,F',C]
            xf, h_new = bsrnn_stack_step(
                plan, x[0].transpose(0, 1).contiguous(), carry["h"])
            mask, res, _ = self._mask_decoder(
                params["mask_decoder"], stats["mask_decoder"],
                xf.permute(1, 0, 2)[..., None])             # [B, F', C, 1]
            return self._apply_mask(spec, mask, res), h_new

        return spectral_step(self, carry, wav_hop, network)

    def stream(self, variables: Params, wav: Tensor, chunk_frames: int = 1,
               fused_plan: tp.Optional[Params] = None) -> Tensor:
        """Whole-utterance streaming, one hop per step, or C hops per step
        with chunk_frames=C (the tail cut to a multiple of C).
        wav [B, hop*T] -> [B, hop*T']; `fused_plan` (build_stack_plan() of
        folded variables) runs the layer stack as one kernel per frame and
        takes one hop per step (ValueError with chunk_frames > 1)."""
        return stream_hops(self, variables, wav, chunk_frames, fused_plan)

    # -- deploy-time folding -------------------------------------------------------

    def fold(self, variables: Params) -> Params:
        """Fuse the pre-norm BNs into the following conv and LSTM input
        weights (reference: models/bsrnn/model.py:14-84)."""
        params, stats = variables["params"], variables["stats"]
        eps = 1e-5

        def bn_wb(bn_p: tp.Optional[Params], bn_s: Params
                  ) -> tp.Tuple[Tensor, Tensor]:
            std = torch.sqrt(bn_s["var"] + eps)
            w = 1.0 / std
            b = -bn_s["mean"] / std
            if bn_p is not None:
                w = bn_p["weight"] * w
                b = b * bn_p["weight"] + bn_p["bias"]
            return w, b

        def fuse_conv(conv: Params, bn_p, bn_s) -> Params:
            w, b = bn_wb(bn_p, bn_s)
            bias = (conv["weight"] * b[None, :, None]).sum(dim=(1, 2))
            if "bias" in conv:
                bias = bias + conv["bias"]
            return {"weight": conv["weight"] * w[None, :, None], "bias": bias}

        def fuse_lstm(rnn: Params, bn_p, bn_s) -> Params:
            w, b = bn_wb(bn_p, bn_s)
            return dict(rnn, bias_ih=rnn["bias_ih"] + rnn["weight_ih"] @ b,
                        weight_ih=rnn["weight_ih"] * w)

        out: Params = {"band_split": [], "layers": [], "mask_decoder": []}
        for p, s in zip(params["band_split"], stats["band_split"]):
            out["band_split"].append({
                "norm": None, "fc": fuse_conv(p["fc"], p["norm"], s["norm"])})
        for p, s in zip(params["layers"], stats["layers"]):
            out["layers"].append({
                "norm_time": None,
                "rnn_time": fuse_lstm(p["rnn_time"], p["norm_time"],
                                      s["norm_time"]),
                "fc_time": p["fc_time"],
                "norm_freq": None,
                "rnn_freq": {d: fuse_lstm(p["rnn_freq"][d], p["norm_freq"],
                                          s["norm_freq"])
                             for d in ("fwd", "bwd")},
                "fc_freq": p["fc_freq"],
            })
        for p, s in zip(params["mask_decoder"], stats["mask_decoder"]):
            out["mask_decoder"].append({
                which: {"norm": None,
                        "conv1": fuse_conv(p[which]["conv1"],
                                           p[which]["norm"], s[which]["norm"]),
                        "conv2": p[which]["conv2"]}
                for which in ("mask", "residual")})
        folded_stats = {"band_split": [{} for _ in self.subbands],
                        "layers": [{} for _ in range(self.num_layers)],
                        "mask_decoder": [{} for _ in self.subbands]}
        return {"params": out, "stats": folded_stats}

    # -- the reference's parameter names (optimizer groups) ---------------------

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """band_split.{norm,fc}.{i}, rnn_time.{i}/rnn_freq.{i} with torch's
        *_l0 and *_l0_reverse LSTM names, mask_decoder.mlp_{mask,residual}.
        {i}.{0 norm, 1 conv1, 3 conv2} (reference models/bsrnn/model.py)."""
        head = path[0]
        if head == "band_split":
            i, mod, leaf = path[1], path[2], path[3]
            return f"band_split.{'norm' if mod == 'norm' else 'fc'}.{i}.{leaf}"
        if head == "layers":
            i, mod = path[1], path[2]
            if mod == "rnn_time":
                return f"rnn_time.{i}.{path[3]}_l0"
            if mod == "rnn_freq":
                sfx = "_l0" if path[3] == "fwd" else "_l0_reverse"
                return f"rnn_freq.{i}.{path[4]}{sfx}"
            return f"{mod}.{i}.{path[3]}"
        if head == "mask_decoder":
            i, which, mod, leaf = path[1], path[2], path[3], path[4]
            seq = {"norm": 0, "conv1": 1, "conv2": 3}[mod]
            return f"mask_decoder.mlp_{which}.{i}.{seq}.{leaf}"
        raise KeyError(f"unmapped bsrnn param path: {path}")

    def fixed_param_paths(self) -> tp.List[tp.Tuple[str, ...]]:
        return []
