"""FastEnhancer's time_kernel ablation, inference and streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/time_kernel.py. The
encoder's frequency convs and the decoder's second convs become causal 2-D
convs over (time k_t, frequency k_f), each with a cache of the last k_t-1
input frames (reference: models/fastenhancer/time_kernel/model.py:119-148);
enc_pre and dec_post stay per-frame 1-D convs, rf_pre and rf_post per-frame
1x1 convs, and the RNNFormer blocks are the default model's. Offline, one
conv runs over the whole utterance with causal left padding; streaming
concatenates the cached frames: the same math, one parameter set. The
streaming carry's "h" is {"h": block carries, "enc": encoder conv caches,
"dec": decoder conv caches}.

Three streaming forms:
* `streaming_step` (inherited): every block through `_block_apply`;
* `streaming_chunk` (inherited): C frames a step; each 2-D conv reads its
  cache before the chunk and keeps the last k_t-1 frames of [cache, chunk];
* `streaming_step_fused` (inherited), on folded variables: the block stack
  is one CUDA kernel per frame in its folded default form
  (ops/rnnformer_stack.py); the 2-D convs run eagerly with their caches.
  It takes one frame per step and raises on T != 1 (the JAX package's
  fused path would take frame 0 only).

The whole-frame kernel (ops/fused_frame.py) has no 2-D conv, so
`build_frame_plan` (its `plan_frame`) raises. `forward(train=True,
row_mask=...)` trains it (JAX time_kernel.py:102-214): every BN in train
mode, the 2-D convs' weighted per batch row ([B, 1, 1, 1]), the others per
frame row ([B*T, 1, 1]); the blocks as the default model's.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from ... import nn as fnn
from ...ops.rnnformer_stack import rnnformer_stack_step
from ...utils.tree import tree_map
from .default import Model as DefaultModel, Params, Tensor, _put
from .dptransformer import set_ablation_filterbanks

Carry = tp.Dict[str, tp.Any]


def causal_conv2d(p: Params, x: Tensor, cache: tp.Optional[Tensor], k_t: int,
                  pad_f: int) -> tp.Tuple[Tensor, Tensor]:
    """x: [B, T, F, Cin]; weight in torch layout [Cout, Cin, k_t, k_f].
    cache: [B, k_t-1, F, Cin], the previous input frames (None: zeros).
    Returns (y [B, T, F', Cout], the new cache)."""
    b, _, f, c = x.shape
    if cache is None:
        cache = x.new_zeros(b, k_t - 1, f, c)
    x = torch.cat([cache, x], dim=1)  # [B, T + k_t - 1, F, Cin]
    new_cache = x[:, x.shape[1] - (k_t - 1):]
    y = F.conv2d(x.permute(0, 3, 1, 2), p["weight"], p.get("bias"),
                 padding=(0, pad_f))
    return y.permute(0, 2, 3, 1), new_cache


class Model(DefaultModel):
    """FastEnhancer time_kernel. Takes the reference's `model_kwargs`
    unchanged (configs/ablation/time_kernel_b.yaml)."""

    def __init__(self, channels: int = 64,
                 kernel_size_freq: tp.Sequence[int] = (8, 3, 3),
                 kernel_size_time: int = 3, stride: int = 4,
                 rnnformer_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
                 final_scale: tp.Union[bool, str] = "exp", **kwargs):
        super().__init__(channels=channels, kernel_size=list(kernel_size_freq),
                         stride=stride, rnnformer_kwargs=rnnformer_kwargs,
                         **kwargs)
        if final_scale not in (True, False, "exp"):
            raise ValueError(f"final_scale must be True, False or 'exp', not "
                             f"{final_scale!r}")
        self.kernel_size_time = kernel_size_time
        self.final_scale = final_scale

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """The default model's tree with 2-D encoder and decoder2 convs and,
        with a pre_post_init, the ablations' absolute-Hz (or mel)
        filterbanks (reference: models/fastenhancer/time_kernel/
        model.py:440-500)."""
        dev = torch.device(device)
        variables = super().init(generator, dev)
        if self.pre_post_init is not None:
            set_ablation_filterbanks(variables["params"], self.freq,
                                     self.rf.freq, self.pre_post_init,
                                     self.sampling_rate, dev)
        return variables

    def _conv_block_init(self, g: torch.Generator, out_ch: int, in_ch: int,
                         k: int, site: str, device: torch.device
                         ) -> tp.Tuple[Params, Params]:
        """The encoder's and decoder2's convs are [Cout, Cin, k_t, k_f],
        torch's default uniform init, no bias; the others the default's."""
        if site not in ("encoder", "decoder2"):
            return super()._conv_block_init(g, out_ch, in_ch, k, site, device)
        k_t = self.kernel_size_time
        bound = 1.0 / (in_ch * k_t * k) ** 0.5
        w = fnn.uniform_init(g, (out_ch, in_ch, k_t, k), bound, device)
        bn_p, bn_s = fnn.init_batch_norm(out_ch, device)
        return {"conv": {"weight": w}, "bn": bn_p}, {"bn": bn_s}

    # -- time-aware forward ----------------------------------------------------

    def model_forward(self, params: Params, stats: Params, spec: Tensor,
                      h0: tp.Optional[Carry] = None, train: bool = False,
                      fused_plan: tp.Optional[Params] = None
                      ) -> tp.Tuple[Tensor, Carry, Params]:
        """spec [B, F, T, 2] -> (mask [B, F, T, 2], carry, stats). h0 is
        None (offline: zero caches) or the streaming carry's "h",
        {"h", "enc", "dec"}. fused_plan (build_stack_plan() of folded
        variables) runs the block stack as one kernel launch; it takes one
        frame (T == 1) and h0["h"] stacked [NB, B*F', C]
        (init_streaming_carry(fused=True)). train=True runs every BN in
        train mode and returns their new statistics."""
        k_t = self.kernel_size_time
        c = self.channels
        b, f_in, t, _ = spec.shape
        if fused_plan is not None and t != 1:
            raise ValueError(f"the fused block stack takes one frame per "
                             f"step (T == 1), not T={t}")
        enc_caches = None if h0 is None else h0["enc"]
        dec_caches = None if h0 is None else h0["dec"]
        block_h = None if h0 is None else h0["h"]
        new_stats = tree_map(lambda a: a, stats) if train else None
        bw_bt = self._bn_w_bt(b, t) if train else None
        bw_b4 = self._bn_w_b(4) if train else None

        def bn2d(p: Params, st: Params, key: str, y: Tensor
                 ) -> tp.Tuple[Tensor, tp.Optional[Params]]:
            """The BN after a 2-D conv (merged away in a folded tree)."""
            if p.get(key) is None:
                return y, None
            y, new = fnn.batch_norm(p[key], st[key], y, train=train,
                                    weight=bw_b4)
            return y, new if train else None

        # Encoder PreNet (per-frame 1-D, as the default model's)
        x = spec.permute(0, 2, 1, 3).reshape(b * t, f_in, 2)
        x, s = self._conv_bn_act(params["enc_pre"], stats["enc_pre"],
                                 self._strided_reshape(x), train=train,
                                 bw=bw_bt)
        _put(new_stats, "enc_pre", s)
        f_enc = x.shape[1]
        x = x.reshape(b, t, f_enc, c)
        skips = [x]
        enc_out = []
        for i, (p, st) in enumerate(zip(params["encoder"], stats["encoder"])):
            k = self.kernel_size[1 + i]
            y, cache = causal_conv2d(
                p["conv"], x, None if enc_caches is None else enc_caches[i],
                k_t, (k - 1) // 2)
            enc_out.append(cache)
            y, s = bn2d(p, st, "bn", y)
            _put(None if new_stats is None else new_stats["encoder"], i,
                 None if s is None else {"bn": s})
            x = self.act(y)
            skips.append(x)

        # rf_pre: frequency resample + 1x1 conv (+BN), per frame
        x2 = torch.einsum("oF,nFc->noc", params["rf_pre"]["lin"]["weight"],
                          x.reshape(b * t, f_enc, c))
        x2, s = self._conv_bn_act(params["rf_pre"], stats["rf_pre"], x2,
                                  act=False, train=train, bw=bw_bt)
        _put(new_stats, "rf_pre", s)
        cc = x2.shape[-1]
        xb = x2.reshape(b, t, self.block_freq, cc).transpose(0, 1)
        if fused_plan is not None:
            if block_h is None:
                block_h = xb.new_zeros(self.num_blocks, b * self.block_freq,
                                       cc)
            y, h_out = rnnformer_stack_step(fused_plan, xb[0].contiguous(),
                                            block_h, self.rf.num_heads)
            xb = y[None]
        else:
            xb, h_out = self._blocks(params, stats, xb, block_h, new_stats)

        x2 = xb.transpose(0, 1).reshape(b * t, self.block_freq, cc)
        x2 = torch.einsum("oF,nFc->noc", params["rf_post"]["lin"]["weight"],
                          x2)
        x2, s = self._conv_bn_act(params["rf_post"], stats["rf_post"], x2,
                                  act=False, train=train, bw=bw_bt)
        _put(new_stats, "rf_post", s)
        x = x2.reshape(b, t, f_enc, c)

        # Decoder: 1x1 conv (per frame), then the causal 2-D conv
        dec_out = []
        for i, (p, st) in enumerate(zip(params["decoder"], stats["decoder"])):
            x = torch.cat([x, skips.pop()], dim=-1)
            y, s1 = self._conv_bn_act(
                {"conv": p["conv1"], "bn": p.get("bn1")},
                {"bn": st.get("bn1")}, x.reshape(b * t, f_enc, 2 * c),
                train=train, bw=bw_bt)
            k = self.kernel_size[len(self.kernel_size) - 1 - i]
            y, cache = causal_conv2d(
                p["conv2"], y.reshape(b, t, f_enc, c),
                None if dec_caches is None else dec_caches[i], k_t,
                (k - 1) // 2)
            dec_out.append(cache)
            y, s2 = bn2d(p, st, "bn2", y)
            if s2 is not None:
                new_stats["decoder"][i] = {"bn1": s1["bn"], "bn2": s2}
            x = self.act(y)

        # Decoder PostNet (per-frame 1-D)
        x = torch.cat([x, skips.pop()], dim=-1).reshape(b * t, f_enc, 2 * c)
        x, s = self._conv_bn_act(params["dec_post"], stats["dec_post"], x,
                                 train=train, bw=bw_bt)
        _put(new_stats, "dec_post", s)
        x = self._scaled_convt(params["dec_post"]["convt"], x)
        mask = self.mask_act(x).reshape(b, t, f_in, 2).permute(0, 2, 1, 3)
        return (mask, {"h": h_out, "enc": enc_out, "dec": dec_out},
                stats if new_stats is None else new_stats)

    # -- streaming -------------------------------------------------------------

    def init_streaming_carry(self, batch: int, dtype: torch.dtype,
                             device: tp.Union[str, torch.device],
                             fused: bool = False) -> Params:
        """The default carry with "h" = {"h": block carries (stacked
        [NB, B*F', C] with fused=True), "enc"/"dec": per-conv frame caches
        [B, k_t-1, F_enc, C]}."""
        carry = super().init_streaming_carry(batch, dtype, device,
                                             fused=fused)
        shape = (batch, self.kernel_size_time - 1, self.freq, self.channels)
        n = len(self.kernel_size) - 1
        carry["h"] = {
            "h": carry["h"],
            "enc": [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)],
            "dec": [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)],
        }
        return carry

    def model_forward_fused(self, variables: Params, plan: Params,
                            spec: Tensor, h: Carry) -> tp.Tuple[Tensor, Carry]:
        """model_forward for one frame with the block stack as one kernel
        launch; the 2-D convs run with their caches. h: the carry's "h"
        from init_streaming_carry(fused=True). Driven by the inherited
        streaming_step_fused."""
        mask, carry, _ = self.model_forward(
            variables["params"], variables["stats"], spec, h0=h,
            fused_plan=plan)
        return mask, carry
