"""FastEnhancer's dptransformer ablation, inference and streaming, in
PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/dptransformer.py. The
default model's time GRU becomes causal local attention over a lookbehind
of L frames, with a learned relative-position bias time_pe [H, L+1] shared
by all blocks (reference: models/fastenhancer/dptransformer/model.py:
174-236, 583-587); the frequency MHSA is the default block's. Streaming
keeps the last L frames' keys and values per block.

Three streaming forms:
* `streaming_step` (inherited): each block's carry is {"k", "v"}
  [B*F', H, L, d] and every frame concatenates the new k/v and drops the
  oldest, as the JAX package's XLA path does;
* `streaming_chunk` (inherited), C frames a step on the same carry: the
  chunk's queries, at positions L..L+C-1, attend to the [cached L, chunk C]
  keys within the lookbehind band, and the last L keys are carried on;
* `streaming_step_fused`, on folded variables: the whole block stack is one
  CUDA kernel per frame (ops/dpt_stack.py) over a rotating-slot K/V cache
  [NB, B, L, F', C'] that is written one slot per block per frame, in
  place, at a slot pointer kept on the device.

`forward(train=True, row_mask=...)` trains it (JAX dptransformer.py:
202-259): train-mode BN over the batch, the causal time attention banded
over the whole segment; no kernel runs.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ... import nn as fnn
from ...functional import init_istft_carry, init_stft_carry
from ...functional.mel import mel_fbank_weights
from ...ops.dpt_stack import (cache_shape, dpt_stack_step, plan_dpt_stack)
from .default import (Model as DefaultModel, Params, Tensor, fold_fc_bn,
                      positional_embedding)


def hz_grid_linear_weights(freq: int, n_filter: int, sr: int = 16_000
                           ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Triangular filterbank on the absolute-Hz grid [n_filter, freq] and
    its row-normalized transpose [freq, n_filter]. Copy of
    fastenhancer_tpu/models/fastenhancer/noncausal.py::hz_grid_linear_weights
    (reference: models/fastenhancer/noncausal/model.py:315-345); it is not
    the default model's `rf_pre_post_weights`."""
    f_filter = np.linspace(0, sr // 2, n_filter)
    delta_f = (sr // 2) / n_filter
    f_freqs = np.linspace(0, sr // 2, freq)
    down = (f_filter[1:, None] - f_freqs[None, :]) / delta_f
    down = np.concatenate([down, np.ones((1, freq))], axis=0)
    up = (f_freqs[None, :] - f_filter[:-1, None]) / delta_f
    up = np.concatenate([np.ones((1, freq)), up], axis=0)
    pre = np.maximum(0.0, np.minimum(down, up))
    post = pre.T.copy()
    pre = pre / pre.sum(axis=1, keepdims=True)
    post = post / post.sum(axis=1, keepdims=True)
    return pre.astype(np.float32), post.astype(np.float32)


def set_ablation_filterbanks(params: Params, freq: int, n_filter: int,
                             init: str, sr: int, device: torch.device) -> None:
    """Put the ablations' own fixed filterbanks (mel for a "mel*" init, else
    the absolute-Hz linear grid) into params["rf_pre"/"rf_post"]["lin"], in
    place (reference: models/fastenhancer/{dprnn,dptransformer,ln,
    time_kernel}/model.py)."""
    make = mel_fbank_weights if init.startswith("mel") else \
        hz_grid_linear_weights
    pre_w, post_w = make(freq, n_filter, sr)
    params["rf_pre"]["lin"]["weight"] = torch.from_numpy(pre_w).to(device)
    params["rf_post"]["lin"]["weight"] = torch.from_numpy(post_w).to(device)


@dataclasses.dataclass
class DPTConfig:
    num_blocks: int = 3
    channels: int = 32
    freq: int = 32
    num_heads: int = 4
    eps: float = 1e-8
    lookbehind: int = 16
    positional_embedding: tp.Optional[str] = "train"
    attn_bias: bool = False
    post_act: bool = False
    pre_norm: bool = False


def banded_bias(pe: Tensor, tq: int, tk: int, lookbehind: int,
                q_offset: int = 0) -> Tensor:
    """pe [H, L+1] -> additive mask [H, tq, tk]: query i (at global position
    i + q_offset) sees key j iff 0 <= (i + q_offset) - j <= L, with bias
    pe[:, L - (i + q_offset - j)], and -inf elsewhere (reference
    expand_attn_map, :151-171)."""
    ti = torch.arange(tq, device=pe.device)[:, None] + q_offset
    tj = torch.arange(tk, device=pe.device)[None, :]
    diff = ti - tj
    valid = (diff >= 0) & (diff <= lookbehind)
    band = pe[:, (lookbehind - diff).clamp(0, lookbehind)]
    return torch.where(valid, band, torch.full_like(band, -math.inf))


class Model(DefaultModel):
    """FastEnhancer dptransformer. Takes the reference's `model_kwargs`
    unchanged (configs/ablation/dpt_*.yaml)."""

    # model_forward_fused takes the K/V caches and the slot pointer apart:
    # no single-carry spec2spec fused step (export it as wav2wav)
    spec2spec_fused = False

    def __init__(
        self,
        channels: int = 64,
        kernel_size: tp.Sequence[int] = (8, 3, 3),
        stride: int = 4,
        dpt_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
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
        final_scale: tp.Union[bool, str] = "exp",
        final_scale_init: str = "1/sqrt(fan_in)",
        normalize_final_conv: bool = False,
        pre_post_init: tp.Optional[str] = None,
        sampling_rate: int = 16_000,
        stft_method: str = "fft",
    ):
        dpt = DPTConfig(**(dpt_kwargs or {}))
        super().__init__(
            channels=channels, kernel_size=kernel_size, stride=stride,
            rnnformer_kwargs=dict(
                num_blocks=dpt.num_blocks, channels=dpt.channels,
                freq=dpt.freq, num_heads=dpt.num_heads, eps=dpt.eps,
                pre_norm=dpt.pre_norm, post_act=dpt.post_act,
                attn_bias=dpt.attn_bias,
                positional_embedding=dpt.positional_embedding),
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
        self.dpt = dpt
        self.final_scale = final_scale
        self.final_scale_init = final_scale_init

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """The default model's tree with dpt blocks, the model-level time
        bias params["time_pe"]["weight"] [H, L+1], and, with a
        pre_post_init, the dpt's own fixed filterbanks (mel, or the
        absolute-Hz linear grid)."""
        dev = torch.device(device)
        variables = super().init(generator, dev)
        cfg = self.dpt
        pe = positional_embedding(cfg.num_heads, cfg.lookbehind + 1)
        params = variables["params"]
        params["time_pe"] = {"weight": torch.from_numpy(pe.T.copy()).to(dev)}
        if self.pre_post_init is not None:
            set_ablation_filterbanks(params, self.freq, cfg.freq,
                                     self.pre_post_init, self.sampling_rate,
                                     dev)
        return variables

    def _block_init(self, g: torch.Generator, i: int,
                    dev: torch.device) -> tp.Tuple[Params, Params]:
        """One dpt block: causal time MHSA + frequency MHSA, each with its
        fc and post-BN residual."""
        cfg = self.dpt
        ch = cfg.channels
        bp: Params = {}
        bs: Params = {}
        for which in ("time", "freq"):
            attn = fnn.init_attention(g, ch, cfg.attn_bias, dev)
            if self.weight_norm:
                attn["qkv"]["weight"] = fnn.to_wn(attn["qkv"]["weight"])
            bn_p, bn_s = fnn.init_batch_norm(ch, dev)
            bp[f"{which}_attn"] = attn
            bp[f"{which}_fc"] = fnn.torch_linear_init(g, ch, ch, False, dev)
            bp[f"{which}_post_norm"] = bn_p
            bs[f"{which}_post_norm"] = bn_s
            if cfg.pre_norm:
                _, bs[f"{which}_pre_norm"] = fnn.init_batch_norm(
                    ch, dev, affine=False)
        if i == 0 and cfg.positional_embedding is not None:
            bp["pe"] = {"weight": torch.from_numpy(
                positional_embedding(ch, cfg.freq)).to(dev)}
        return bp, bs

    # -- time attention -------------------------------------------------------

    def _time_attn(self, p: Params, pe: Tensor, x: Tensor,
                   carry: tp.Optional[Params]) -> tp.Tuple[Tensor, Params]:
        """x: [B*F, T, C]; carry: {"k", "v"} [B*F, H, L, d] or None (offline:
        banded causal attention over the T frames). With a carry and T > 1
        (a chunk) the queries sit at positions L..L+T-1 of the [cached L,
        chunk T] keys. Returns (out [B*F, T, C], the last L frames'
        {"k", "v"})."""
        cfg = self.dpt
        nh, lb = cfg.num_heads, cfg.lookbehind
        bf, t, c = x.shape
        d = c // nh
        qkv = x @ fnn.maybe_wn_weight(p["qkv"], "weight").T
        if "bias" in p["qkv"]:
            qkv = qkv + p["qkv"]["bias"]
        qkv = qkv.reshape(bf, t, nh, 3 * d).transpose(1, 2)  # [BF, H, T, 3d]
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        # the JAX path's scale, in the activation dtype
        scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=x.dtype))
        if carry is None:
            band = banded_bias(pe.float(), t, t, lb)
            logits = torch.einsum("bhtc,bhsc->bhts", q, k) * scale
            probs = torch.softmax(logits.float() + band, dim=-1).to(x.dtype)
            out = torch.einsum("bhts,bhsc->bhtc", probs, v)
        elif t == 1:
            k = torch.cat([carry["k"], k], dim=2)              # [BF, H, L+1, d]
            v = torch.cat([carry["v"], v], dim=2)
            logits = (q * k).sum(dim=3) * scale                # [BF, H, L+1]
            probs = torch.softmax(logits.float() + pe.float(), dim=2).to(
                x.dtype)
            out = torch.einsum("bhs,bhsc->bhc", probs, v)[:, :, None, :]
        else:
            k = torch.cat([carry["k"], k], dim=2)             # [BF, H, L+T, d]
            v = torch.cat([carry["v"], v], dim=2)
            band = banded_bias(pe.float(), t, lb + t, lb, q_offset=lb)
            logits = torch.einsum("bhtc,bhsc->bhts", q, k) * scale
            probs = torch.softmax(logits.float() + band, dim=-1).to(x.dtype)
            out = torch.einsum("bhts,bhsc->bhtc", probs, v)
        new_carry = {"k": k[:, :, -lb:], "v": v[:, :, -lb:]}
        return out.transpose(1, 2).reshape(bf, t, c), new_carry

    def _block_extra(self, params: Params) -> Params:
        """The model-level time bias every block's time attention reads."""
        return {"pe_time": params["time_pe"]["weight"]}

    def _block_apply(self, p: Params, s: Params, x: Tensor,
                     h0: tp.Optional[Params], train: bool = False,
                     bw: tp.Optional[Tensor] = None,
                     pe_time: tp.Optional[Tensor] = None
                     ) -> tp.Tuple[Tensor, Params, tp.Optional[Params]]:
        """x: [T, B, F', C] -> (x, the block's new {"k", "v"}, its new
        statistics in train mode, else None); in train mode the BNs run on
        the batch, weighted by `bw`."""
        cfg = self.dpt
        t, b, f, c = x.shape
        new_s = dict(s) if train and s else None

        def bn(bn_p: tp.Optional[Params], key: str, y: Tensor) -> Tensor:
            y, st = fnn.batch_norm(bn_p, s[key], y, train=train, eps=cfg.eps,
                                   weight=bw)
            if new_s is not None:
                new_s[key] = st
            return y

        # --- causal time attention ---
        x_in = x
        y = x
        if s and "time_pre_norm" in s:
            y = bn(None, "time_pre_norm", y)
        y = y.permute(1, 2, 0, 3).reshape(b * f, t, c)
        y, h_t = self._time_attn(p["time_attn"], pe_time, y, h0)
        y = y.reshape(b, f, t, c).permute(2, 0, 1, 3)
        y = fnn.linear(p["time_fc"], y)
        if p.get("time_post_norm") is not None:
            y = bn(p["time_post_norm"], "time_post_norm", y)
        if cfg.post_act:
            y = self.act(y)
        x = y + x_in
        if "pe" in p:
            x = x + p["pe"]["weight"]
        # --- frequency attention ---
        x_in = x
        y = x
        if s and "freq_pre_norm" in s:
            y = bn(None, "freq_pre_norm", y)
        y = fnn.attention(p["freq_attn"], y.reshape(t * b, f, c),
                          cfg.num_heads)
        y = fnn.linear(p["freq_fc"], y.reshape(t, b, f, c))
        if p.get("freq_post_norm") is not None:
            y = bn(p["freq_post_norm"], "freq_post_norm", y)
        if cfg.post_act:
            y = self.act(y)
        return y + x_in, h_t, new_s

    def _block_carry_init(self, batch: int, dtype: torch.dtype,
                          device: tp.Union[str, torch.device]) -> Params:
        cfg = self.dpt
        shape = (batch * cfg.freq, cfg.num_heads, cfg.lookbehind,
                 cfg.channels // cfg.num_heads)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    # -- fused-stack streaming (CUDA kernel) -------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """fused=False: the default carry with per-block {"k", "v"}.
        fused=True: {"stft", "istft", "kc", "vc", "ptr"}, the rotating-slot
        K/V caches [NB, B, L, F', C'] (zeros) and their shared slot pointer,
        an int32 tensor of shape () on `device`. A zeroed slot is correct at
        any pointer value (ops/dpt_stack.py), so the serving engine may reset
        one stream's rows while the pointer moves on."""
        if not fused:
            return super().init_streaming_carry(batch, dtype, device)
        cfg = self.dpt
        shape = cache_shape(cfg.num_blocks, batch, cfg.lookbehind, cfg.freq,
                            cfg.channels)
        return {"stft": init_stft_carry(self.stft_cfg, batch, dtype, device),
                "istft": init_istft_carry(self.stft_cfg, batch, dtype, device),
                "kc": torch.zeros(shape, dtype=dtype, device=device),
                "vc": torch.zeros(shape, dtype=dtype, device=device),
                "ptr": torch.zeros((), dtype=torch.int32, device=device)}

    def build_stack_plan(self, variables: Params,
                         dtype: tp.Optional[torch.dtype] = None) -> Params:
        """Pack FOLDED variables for the dpt-stack kernel
        (ops/dpt_stack.py). The kernel implements only the deploy-time
        block form (post-BNs merged into the fcs, pre-norms into the qkv,
        post_act=False)."""
        if self.dpt.post_act:
            raise NotImplementedError("fused dpt stack: post_act recipes")
        if any(variables["stats"]["rf_blocks"]):
            raise ValueError("build_stack_plan expects fold() output")
        params = variables["params"]
        return plan_dpt_stack(params["rf_blocks"], params["time_pe"]["weight"],
                              self.dpt.freq, self.dpt.num_heads, dtype=dtype)

    def model_forward_fused(self, variables: Params, plan: Params,
                            spec: Tensor, kc: Tensor, vc: Tensor, ptr: Tensor
                            ) -> tp.Tuple[Tensor, Tensor]:
        """model_forward for one frame, inference, with the block stack as
        one kernel launch. spec: compressed [B, F, 1, 2]; kc/vc: the
        rotating caches, updated in place; ptr: the slot pointer ->
        (mask [B, F, 1, 2], the advanced pointer)."""
        params, stats = variables["params"], variables["stats"]
        x, x_res, skips, b, t = self._encode(params, stats, spec)
        y, ptr = dpt_stack_step(plan, x[0].contiguous(), kc, vc, ptr,
                                self.dpt.num_heads)
        mask = self._decode(params, stats, y[None], x_res, skips, b, t,
                            spec.shape[1])
        return mask, ptr

    def streaming_step_fused(self, variables: Params, plan: Params,
                             carry: Params, wav_hop: Tensor
                             ) -> tp.Tuple[Params, Tensor]:
        """streaming_step with the block stack as one kernel per frame and
        the K/V shift replaced by one slot write per block; same math as
        streaming_step on folded variables. The carry's kc and vc are
        updated in place and returned in the new carry."""
        spec, stft_c = self._stream_front(carry, wav_hop)
        mask, ptr = self.model_forward_fused(variables, plan, spec,
                                             carry["kc"], carry["vc"],
                                             carry["ptr"])
        base, wav_out = self._stream_back(spec, mask, carry, stft_c, None)
        return {"stft": base["stft"], "istft": base["istft"],
                "kc": carry["kc"], "vc": carry["vc"], "ptr": ptr}, wav_out

    # -- deploy-time folding -----------------------------------------------------

    def _block_fold(self, bp: Params, bs: Params) -> Params:
        """Fold one block: post-BN into each fc, pre-norm into each qkv."""
        eps = self.dpt.eps
        nb: Params = {}
        for which in ("time", "freq"):
            attn = bp[f"{which}_attn"]["qkv"]
            qkv_w = fnn.maybe_wn_weight(attn, "weight")
            qkv: Params = {"weight": qkv_w}
            if "bias" in attn:
                qkv["bias"] = attn["bias"]
            if self.dpt.pre_norm:
                st = bs[f"{which}_pre_norm"]
                std = torch.sqrt(st["var"] + eps)
                beta = -st["mean"] / std
                bias0 = qkv.get("bias", qkv_w.new_zeros(qkv_w.shape[0]))
                qkv = {"weight": qkv_w / std, "bias": bias0 + qkv_w @ beta}
            nb[f"{which}_attn"] = {"qkv": qkv}
            nb[f"{which}_fc"] = fold_fc_bn(bp[f"{which}_fc"],
                                           bp[f"{which}_post_norm"],
                                           bs[f"{which}_post_norm"], eps)
            nb[f"{which}_post_norm"] = None
        if "pe" in bp:
            nb["pe"] = bp["pe"]
        return nb

    def fold(self, variables: Params) -> Params:
        out = super().fold(variables)
        out["params"]["time_pe"] = variables["params"]["time_pe"]
        return out

    # -- the reference's parameter names (optimizer groups) -------------------

    def fixed_param_paths(self) -> tp.List[tp.Tuple[str, ...]]:
        fixed = [f for f in super().fixed_param_paths()
                 if f != ("rf_blocks", "0", "pe", "weight")]
        if self.dpt.positional_embedding == "fixed":
            fixed.append(("rf_blocks", "0", "pe", "weight"))
        return fixed

    tname_prepost = "dpt"
    tname_block = "dpt_block"

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """dpt_block.{i}.{time,freq}_attn.qkv..., the shared time bias as
        `pe`; the rest as the default's under the dpt prefixes."""
        if path[0] == "time_pe":
            return "pe"
        if path[0] == "rf_blocks":
            i, mod = path[1], path[2]
            prefix = f"dpt_block.{i}"
            if mod in ("time_attn", "freq_attn"):
                leaf = path[4]
                sub = path[5] if len(path) > 5 else None
                if leaf == "weight":
                    if sub is None:
                        return f"{prefix}.{mod}.qkv.weight"
                    which = "original0" if sub == "g" else "original1"
                    return f"{prefix}.{mod}.qkv.parametrizations.weight.{which}"
                return f"{prefix}.{mod}.qkv.{leaf}"
            if mod == "pe":
                return f"{prefix}.pe"
            return f"{prefix}.{mod}.{path[3]}"
        return super().torch_name(path)
