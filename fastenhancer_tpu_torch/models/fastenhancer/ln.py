"""FastEnhancer's ln ablation, inference and streaming, in PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/ln.py. Every BatchNorm
becomes a sample-local norm: the conv units use GroupNorm(1, C)
(`nn.layer_norm_fc` over [F, C]) and the RNNFormer blocks a LayerNorm over
[F', C'] after each fc (reference: models/fastenhancer/ln/model.py:16-37,
210-221, 427-509). Nothing folds away at deploy time (the ablation exists
to show that the BN fold is what makes the default fast): `fold` strips
weight norm and the final scale only.

Three streaming forms:
* `streaming_step` (inherited): the default model's per-frame graph with
  these norms;
* `streaming_chunk` (inherited): C frames a step, each block's time GRU one
  gru_scan launch over the chunk;
* `streaming_step_fused` (inherited), on folded variables: the block stack
  is one CUDA kernel per frame in its LN form (ops/rnnformer_stack.py,
  `plan_stack(..., ln_eps=...)`), which applies both LayerNorms inline.

The whole-frame kernel (ops/fused_frame.py) has no GroupNorm or LayerNorm,
so `build_frame_plan` (its `plan_frame`) raises. `forward(train=True)`
trains it (JAX ln.py:94 onwards): no norm keeps batch statistics, so train
mode differs from eval only in the time GRU, nn.gru's differentiable loop.
"""
from __future__ import annotations

import typing as tp

import torch

from ... import nn as fnn
from ...ops.gru_scan import gru_fused
from ...ops.rnnformer_stack import plan_stack
from .default import Model as DefaultModel, Params, Tensor
from .dptransformer import set_ablation_filterbanks

def ref_layer_norm(params: tp.Optional[Params], x: Tensor,
                   eps: float) -> Tensor:
    """The reference ln-ablation LayerNorm over the last two axes, with its
    affine quirk kept: the affine branch computes
        diff + inv_std * weight * bias
    (the normalized diff is never scaled; models/fastenhancer/ln/model.py:
    27-37 uses `diff.addcmul(w, bias)`). Checkpoints were trained with it,
    so parity means matching it. params=None normalizes properly:
    diff * inv_std. Statistics in float32, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    diff = xf - mean
    var = diff.square().mean(dim=(-2, -1), keepdim=True)
    inv = torch.rsqrt(var + eps)
    if params is not None:
        y = diff + inv * params["weight"] * params["bias"]
    else:
        y = diff * inv
    return y.to(x.dtype)


class Model(DefaultModel):
    """FastEnhancer ln. Takes the reference's `model_kwargs` unchanged
    (configs/ablation/ln_b.yaml)."""

    # per-site conv bias (reference: models/fastenhancer/ln/model.py:422-510)
    _SITE_BIAS = {"enc_pre": True, "encoder": True, "rf_pre": True,
                  "rf_post": True, "decoder1": True, "decoder2": False,
                  "dec_post": False}

    def __init__(self, *args,
                 final_scale: tp.Union[bool, str] = "exp",
                 final_scale_init: str = "1/sqrt(fan_in)", **kwargs):
        super().__init__(*args, **kwargs)
        if final_scale not in (True, False, "exp"):
            raise ValueError(f"final_scale must be True, False or 'exp', not "
                             f"{final_scale!r}")
        self.final_scale = final_scale
        self.final_scale_init = final_scale_init

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """The default model's tree with GroupNorm conv units and LayerNorm
        post-norms and, with a pre_post_init, the absolute-Hz (or mel)
        filterbanks the ablations share (reference:
        models/fastenhancer/ln/model.py:295-350)."""
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
        p = fnn.torch_conv1d_init(g, out_ch, in_ch, k,
                                  self._SITE_BIAS.get(site, False), device)
        return {"conv": p, "gn": fnn.init_layer_norm(out_ch, device)}, {}

    def _block_init(self, g: torch.Generator, i: int,
                    dev: torch.device) -> tp.Tuple[Params, Params]:
        """The default block with LayerNorm post-norms (params only, no
        running statistics)."""
        bp, _ = super()._block_init(g, i, dev)
        ch = self.rf.channels
        bp["rnn_post_norm"] = {"ln": fnn.init_layer_norm(ch, dev)}
        bp["attn_post_norm"] = {"ln": fnn.init_layer_norm(ch, dev)}
        if self.rf.pre_norm:
            bp["rnn_pre_norm"] = {"ln": None}
            bp["attn_pre_norm"] = {"ln": None}
        return bp, {}

    def _block_apply(self, p: Params, s: Params, x: Tensor,
                     h0: tp.Optional[Tensor], train: bool = False,
                     bw: tp.Optional[Tensor] = None
                     ) -> tp.Tuple[Tensor, Tensor, None]:
        """x: [T, B, F', C] -> (x, h_T [B*F', C], None: no statistics).
        The time GRU is one gru_scan launch in eval, nn.gru's loop in
        train; `bw` is unused (LayerNorm is per frame)."""
        del s, bw
        rf = self.rf
        t, b, f, c = x.shape
        eps = rf.eps
        # --- time GRU ---
        x_in = x
        y = x
        if "rnn_pre_norm" in p:
            y = ref_layer_norm(p["rnn_pre_norm"]["ln"], y, eps)
        if h0 is None:
            h0 = x.new_zeros(b * f, c)
        gru = fnn.gru if train else gru_fused
        y, h_t = gru(p["rnn"], y.reshape(t, b * f, c), h0)
        y = fnn.linear(p["rnn_fc"], y.reshape(t, b, f, c))
        if p.get("rnn_post_norm") is not None:
            y = ref_layer_norm(p["rnn_post_norm"]["ln"], y, eps)
        if rf.post_act:
            y = self.act(y)
        x = y + x_in
        # --- positional embedding (block 0 only) ---
        if "pe" in p:
            x = x + p["pe"]["weight"]
        # --- frequency attention ---
        x_in = x
        y = x
        if "attn_pre_norm" in p:
            y = ref_layer_norm(p["attn_pre_norm"]["ln"], y, eps)
        y = fnn.attention(p["attn"], y.reshape(t * b, f, c), rf.num_heads)
        y = fnn.linear(p["attn_fc"], y.reshape(t, b, f, c))
        if p.get("attn_post_norm") is not None:
            y = ref_layer_norm(p["attn_post_norm"]["ln"], y, eps)
        if rf.post_act:
            y = self.act(y)
        return y + x_in, h_t, None

    def fold(self, variables: Params) -> Params:
        """Strip weight norm and the final scale only: GroupNorm and
        LayerNorm depend on the data and cannot fold (the ablation's
        finding). The statistics tree (empty) is kept as it is."""
        def strip(tree: tp.Any) -> tp.Any:
            if isinstance(tree, dict):
                if set(tree) == {"g", "v"}:
                    return fnn.wn_weight(tree)
                return {k: strip(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [strip(v) for v in tree]
            return tree

        out = strip(variables["params"])
        convt = dict(out["dec_post"]["convt"])
        if "scale" in convt:
            w = convt["weight"]
            scale = self._convt_scale(convt)
            del convt["scale"]
            if self.normalize_final_conv:
                w = w / w.square().sum().sqrt().clamp_min(1e-12)
            convt["weight"] = w * scale
        out["dec_post"]["convt"] = convt
        return {"params": out, "stats": variables["stats"]}

    def build_stack_plan(self, variables: Params,
                         dtype: tp.Optional[torch.dtype] = None) -> Params:
        """Pack FOLDED rf_blocks params for the block-stack kernel in its
        LN form (plan_stack(..., ln_eps=rf.eps)): the LayerNorms cannot
        fold, so the kernel applies them inline after each fc."""
        if self.rf.post_act:
            raise NotImplementedError("fused ln stack: post_act recipes")
        if self.rf.pre_norm:
            raise NotImplementedError("fused ln stack: pre_norm recipes")
        return plan_stack(variables["params"]["rf_blocks"], self.block_freq,
                          self.rf.num_heads, dtype=dtype, ln_eps=self.rf.eps)

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """GroupNorm sits at BatchNorm's sequential indices; the blocks'
        LayerNorm params at the same attribute names."""
        ren = {"gn": "bn", "gn1": "bn1", "gn2": "bn2"}
        key = tuple(ren.get(p, p) for p in path)
        if key[0] == "rf_blocks" and len(key) > 2 and key[2].endswith("_norm"):
            return f"rf_block.{key[1]}.{key[2]}.{key[4]}"
        return super().torch_name(key)
