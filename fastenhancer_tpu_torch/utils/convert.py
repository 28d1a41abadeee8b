"""Torch checkpoint -> the port's variables, for every model family.

The port's copy of fastenhancer_tpu/utils/convert.py, converter for
converter. A reference `state_dict` (as the PyTorch repo's checkpoints hold
it, reference: wrappers/ns.py:323-336) becomes the port's {"params",
"stats"} tree of tensors, with the same paths as the JAX package's
converter gives (and as `utils/bridge.py::from_jax` carries across),
weight-norm parametrization pairs (original0/original1 -> {g, v}) and the
BatchNorm running statistics included.

Every tensor taken from the state dict is copied onto `device` (the first
CUDA card unless one is named; the tests pass the CPU), so later in-place
updates of the caller's tensors (e.g. BN running statistics during a
train-mode forward) cannot reach the converted tree. Float64 arrays become
float32, as in the JAX package (which runs with x64 off).

A `.pth` file is read by the caller:

    sd = torch.load(path, map_location="cpu", weights_only=True)
    variables = convert_checkpoint(sd, hps.model, hps.model_kwargs)
"""
from __future__ import annotations

import re
import typing as tp

import numpy as np
import torch

Params = tp.Dict[str, tp.Any]


class _StateDict:
    """A reference state dict read key by key: each read is a fresh copy on
    the device (so no two leaves share storage), and a missing key raises
    KeyError naming it."""

    def __init__(self, sd: tp.Mapping[str, tp.Any],
                 device: tp.Optional[torch.device]):
        if isinstance(sd, _StateDict):
            sd, device = sd.sd, sd.device
        if device is None:
            from .. import require_cuda

            device = require_cuda()
        self.sd, self.device = sd, torch.device(device)

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def __getitem__(self, key: str) -> torch.Tensor:
        v = self.sd[key]
        if isinstance(v, torch.Tensor):
            t = v.detach().to(self.device, copy=True)
        else:
            t = torch.tensor(np.asarray(v), device=self.device)
        return t.float() if t.dtype == torch.float64 else t


def _bn(sd: _StateDict, prefix: str, affine: bool = True
        ) -> tp.Tuple[tp.Optional[Params], Params]:
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    if not affine:
        return None, stats
    params = {"weight": sd[f"{prefix}.weight"],
              "bias": sd[f"{prefix}.bias"]}
    return params, stats


def _maybe_wn(sd: _StateDict, base: str, weight_name: str = "weight"
              ) -> tp.Any:
    """Return {g,v} if the key is weight-norm parametrized, else the weight."""
    p0 = f"{base}.parametrizations.{weight_name}.original0"
    if p0 in sd:
        return {"g": sd[p0],
                "v": sd[f"{base}.parametrizations.{weight_name}.original1"]}
    return sd[f"{base}.{weight_name}"]


def convert_fastenhancer_default(
    state_dict: tp.Mapping[str, tp.Any],
    num_blocks: int,
    num_encoder: int,
    pre_norm: bool = False,
    device: tp.Optional[torch.device] = None,
) -> Params:
    """Reference `fastenhancer.default` Model/ONNXModel state_dict -> variables.

    Key layout (reference: models/fastenhancer/default/model.py:383-521):
      enc_pre.{0,1}, encoder.{i}.{0,1}, rf_pre.{0,1,2}, rf_block.{i}.*,
      rf_post.{0,1,2}, decoder.{i}.{0,1,3,4}, dec_post.{0,1,3}.
    """
    sd = _StateDict(state_dict, device)
    params: Params = {}
    stats: Params = {}

    def conv_bn(conv_key: str, bn_key: str) -> tp.Tuple[Params, Params]:
        bn_p, bn_s = _bn(sd, bn_key)
        return ({"conv": {"weight": sd[f"{conv_key}.weight"]},
                 "bn": bn_p}, {"bn": bn_s})

    params["enc_pre"], stats["enc_pre"] = conv_bn("enc_pre.0", "enc_pre.1")
    params["encoder"], stats["encoder"] = [], []
    for i in range(num_encoder):
        p, s = conv_bn(f"encoder.{i}.0", f"encoder.{i}.1")
        params["encoder"].append(p)
        stats["encoder"].append(s)

    for name in ("rf_pre", "rf_post"):
        p, s = conv_bn(f"{name}.1", f"{name}.2")
        params[name] = {"lin": {"weight": sd[f"{name}.0.weight"]}, **p}
        stats[name] = s

    params["rf_blocks"], stats["rf_blocks"] = [], []
    for i in range(num_blocks):
        b = f"rf_block.{i}"
        rnn = {
            "weight_ih": _maybe_wn(sd, f"{b}.rnn", "weight_ih_l0"),
            "weight_hh": _maybe_wn(sd, f"{b}.rnn", "weight_hh_l0"),
            "bias_ih": sd[f"{b}.rnn.bias_ih_l0"],
            "bias_hh": sd[f"{b}.rnn.bias_hh_l0"],
        }
        qkv: Params = {"weight": _maybe_wn(sd, f"{b}.attn.qkv")}
        if f"{b}.attn.qkv.bias" in sd:
            qkv["bias"] = sd[f"{b}.attn.qkv.bias"]
        rnn_norm_p, rnn_norm_s = _bn(sd, f"{b}.rnn_post_norm")
        attn_norm_p, attn_norm_s = _bn(sd, f"{b}.attn_post_norm")
        bp: Params = {
            "rnn": rnn,
            "rnn_fc": {"weight": sd[f"{b}.rnn_fc.weight"]},
            "rnn_post_norm": rnn_norm_p,
            "attn": {"qkv": qkv},
            "attn_fc": {"weight": sd[f"{b}.attn_fc.weight"]},
            "attn_post_norm": attn_norm_p,
        }
        bs: Params = {"rnn_post_norm": rnn_norm_s, "attn_post_norm": attn_norm_s}
        if pre_norm:
            _, bs["rnn_pre_norm"] = _bn(sd, f"{b}.rnn_pre_norm", affine=False)
            _, bs["attn_pre_norm"] = _bn(sd, f"{b}.attn_pre_norm", affine=False)
        if f"{b}.pe" in sd:
            bp["pe"] = {"weight": sd[f"{b}.pe"]}
        params["rf_blocks"].append(bp)
        stats["rf_blocks"].append(bs)

    params["decoder"], stats["decoder"] = [], []
    for i in range(num_encoder):
        p1, s1 = conv_bn(f"decoder.{i}.0", f"decoder.{i}.1")
        p2, s2 = conv_bn(f"decoder.{i}.3", f"decoder.{i}.4")
        params["decoder"].append({"conv1": p1["conv"], "bn1": p1["bn"],
                                  "conv2": p2["conv"], "bn2": p2["bn"]})
        stats["decoder"].append({"bn1": s1["bn"], "bn2": s2["bn"]})

    p1, s1 = conv_bn("dec_post.0", "dec_post.1")
    convt: Params = {"weight": sd["dec_post.3.weight"],
                     "bias": sd["dec_post.3.bias"]}
    if "dec_post.3.scale" in sd:
        convt["scale"] = sd["dec_post.3.scale"]
    params["dec_post"] = {**p1, "convt": convt}
    stats["dec_post"] = s1
    return {"params": params, "stats": stats}


def _gru(sd, base: str, suffix: str = "_l0") -> Params:
    return {
        "weight_ih": _maybe_wn(sd, base, f"weight_ih{suffix}"),
        "weight_hh": _maybe_wn(sd, base, f"weight_hh{suffix}"),
        "bias_ih": sd[f"{base}.bias_ih{suffix}"],
        "bias_hh": sd[f"{base}.bias_hh{suffix}"],
    }


def _bigru(sd, base: str) -> Params:
    return {"fwd": _gru(sd, base, "_l0"), "bwd": _gru(sd, base, "_l0_reverse")}


def convert_fastenhancer_noncausal(
    state_dict, num_blocks: int, num_encoder: int, pre_norm: bool = False,
    device: tp.Optional[torch.device] = None,
) -> Params:
    """Bidirectional-GRU variant: rnn gains *_l0_reverse weights
    (reference: models/fastenhancer/noncausal/model.py:186-221)."""
    sd = _StateDict(state_dict, device)
    out = convert_fastenhancer_default(sd, num_blocks, num_encoder, pre_norm)
    for i in range(num_blocks):
        out["params"]["rf_blocks"][i]["rnn"] = _bigru(sd, f"rf_block.{i}.rnn")
    return out


def convert_fastenhancer_dprnn(
    state_dict, num_blocks: int, num_encoder: int, pre_norm: bool = False,
    device: tp.Optional[torch.device] = None,
) -> Params:
    """DPRNN ablation (reference: models/fastenhancer/dprnn/model.py):
    module prefixes dprnn_pre/dprnn_post/dprnn_block.{i}.{trnn,frnn,...}."""
    sd = _StateDict(state_dict, device)
    params: Params = {}
    stats: Params = {}

    def conv_bn(conv_key: str, bn_key: str):
        bn_p, bn_s = _bn(sd, bn_key)
        return ({"conv": {"weight": sd[f"{conv_key}.weight"]},
                 "bn": bn_p}, {"bn": bn_s})

    params["enc_pre"], stats["enc_pre"] = conv_bn("enc_pre.0", "enc_pre.1")
    params["encoder"], stats["encoder"] = [], []
    for i in range(num_encoder):
        p, s = conv_bn(f"encoder.{i}.0", f"encoder.{i}.1")
        params["encoder"].append(p)
        stats["encoder"].append(s)
    for ours, theirs in (("rf_pre", "dprnn_pre"), ("rf_post", "dprnn_post")):
        p, s = conv_bn(f"{theirs}.1", f"{theirs}.2")
        params[ours] = {"lin": {"weight": sd[f"{theirs}.0.weight"]},
                        **p}
        stats[ours] = s

    params["rf_blocks"], stats["rf_blocks"] = [], []
    for i in range(num_blocks):
        b = f"dprnn_block.{i}"
        t_norm_p, t_norm_s = _bn(sd, f"{b}.trnn_post_norm")
        f_norm_p, f_norm_s = _bn(sd, f"{b}.frnn_post_norm")
        bp: Params = {
            "trnn": _gru(sd, f"{b}.trnn"),
            "trnn_fc": {"weight": sd[f"{b}.trnn_fc.weight"]},
            "trnn_post_norm": t_norm_p,
            "frnn": _bigru(sd, f"{b}.frnn"),
            "frnn_fc": {"weight": sd[f"{b}.frnn_fc.weight"]},
            "frnn_post_norm": f_norm_p,
        }
        bs: Params = {"trnn_post_norm": t_norm_s, "frnn_post_norm": f_norm_s}
        if pre_norm:
            _, bs["trnn_pre_norm"] = _bn(sd, f"{b}.trnn_pre_norm", affine=False)
            _, bs["frnn_pre_norm"] = _bn(sd, f"{b}.frnn_pre_norm", affine=False)
        params["rf_blocks"].append(bp)
        stats["rf_blocks"].append(bs)

    params["decoder"], stats["decoder"] = [], []
    for i in range(num_encoder):
        p1, s1 = conv_bn(f"decoder.{i}.0", f"decoder.{i}.1")
        p2, s2 = conv_bn(f"decoder.{i}.3", f"decoder.{i}.4")
        params["decoder"].append({"conv1": p1["conv"], "bn1": p1["bn"],
                                  "conv2": p2["conv"], "bn2": p2["bn"]})
        stats["decoder"].append({"bn1": s1["bn"], "bn2": s2["bn"]})
    p1, s1 = conv_bn("dec_post.0", "dec_post.1")
    convt: Params = {"weight": sd["dec_post.3.weight"],
                     "bias": sd["dec_post.3.bias"]}
    if "dec_post.3.scale" in sd:
        convt["scale"] = sd["dec_post.3.scale"]
    params["dec_post"] = {**p1, "convt": convt}
    stats["dec_post"] = s1
    return {"params": params, "stats": stats}


def convert_fastenhancer_ln(
    state_dict, num_blocks: int, num_encoder: int, pre_norm: bool = False,
    device: tp.Optional[torch.device] = None,
) -> Params:
    """ln ablation: GroupNorm/LayerNorm params instead of BN stats
    (reference: models/fastenhancer/ln/model.py)."""
    sd = _StateDict(state_dict, device)
    params: Params = {}

    def conv_gn(conv_key: str, gn_key: str) -> Params:
        conv = {"weight": sd[f"{conv_key}.weight"]}
        if f"{conv_key}.bias" in sd:  # ln convs keep their biases
            conv["bias"] = sd[f"{conv_key}.bias"]
        return {"conv": conv,
                "gn": {"weight": sd[f"{gn_key}.weight"],
                       "bias": sd[f"{gn_key}.bias"]}}

    params["enc_pre"] = conv_gn("enc_pre.0", "enc_pre.1")
    params["encoder"] = [conv_gn(f"encoder.{i}.0", f"encoder.{i}.1")
                         for i in range(num_encoder)]
    for name in ("rf_pre", "rf_post"):
        params[name] = {"lin": {"weight": sd[f"{name}.0.weight"]},
                        **conv_gn(f"{name}.1", f"{name}.2")}
    params["rf_blocks"] = []
    for i in range(num_blocks):
        b = f"rf_block.{i}"
        qkv: Params = {"weight": _maybe_wn(sd, f"{b}.attn.qkv")}
        if f"{b}.attn.qkv.bias" in sd:
            qkv["bias"] = sd[f"{b}.attn.qkv.bias"]
        bp: Params = {
            "rnn": _gru(sd, f"{b}.rnn"),
            "rnn_fc": {"weight": sd[f"{b}.rnn_fc.weight"]},
            "rnn_post_norm": {"ln": {
                "weight": sd[f"{b}.rnn_post_norm.weight"],
                "bias": sd[f"{b}.rnn_post_norm.bias"]}},
            "attn": {"qkv": qkv},
            "attn_fc": {"weight": sd[f"{b}.attn_fc.weight"]},
            "attn_post_norm": {"ln": {
                "weight": sd[f"{b}.attn_post_norm.weight"],
                "bias": sd[f"{b}.attn_post_norm.bias"]}},
        }
        if pre_norm:
            bp["rnn_pre_norm"] = {"ln": None}
            bp["attn_pre_norm"] = {"ln": None}
        if f"{b}.pe" in sd:
            bp["pe"] = {"weight": sd[f"{b}.pe"]}
        params["rf_blocks"].append(bp)
    params["decoder"] = [
        {"conv1": conv_gn(f"decoder.{i}.0", f"decoder.{i}.1")["conv"],
         "bn1": None,
         "gn1": conv_gn(f"decoder.{i}.0", f"decoder.{i}.1")["gn"],
         "conv2": conv_gn(f"decoder.{i}.3", f"decoder.{i}.4")["conv"],
         "bn2": None,
         "gn2": conv_gn(f"decoder.{i}.3", f"decoder.{i}.4")["gn"]}
        for i in range(num_encoder)
    ]
    convt: Params = {"weight": sd["dec_post.3.weight"],
                     "bias": sd["dec_post.3.bias"]}
    if "dec_post.3.scale" in sd:
        convt["scale"] = sd["dec_post.3.scale"]
    params["dec_post"] = {**conv_gn("dec_post.0", "dec_post.1"),
                          "convt": convt}
    stats = {"enc_pre": {}, "encoder": [{} for _ in range(num_encoder)],
             "rf_pre": {}, "rf_post": {},
             "rf_blocks": [{} for _ in range(num_blocks)],
             "decoder": [{} for _ in range(num_encoder)], "dec_post": {}}
    return {"params": params, "stats": stats}


def convert_fastenhancer_dpt(
    state_dict, num_blocks: int, num_encoder: int, pre_norm: bool = False,
    device: tp.Optional[torch.device] = None,
) -> Params:
    """dptransformer ablation (reference: models/fastenhancer/dptransformer/
    model.py): dpt_pre/dpt_post/dpt_block.{i}.{time_attn,freq_attn,...} and a
    model-level relative position bias `pe` [NH, L+1]."""
    sd = _StateDict(state_dict, device)
    params: Params = {}
    stats: Params = {}

    def conv_bn(conv_key: str, bn_key: str):
        bn_p, bn_s = _bn(sd, bn_key)
        return ({"conv": {"weight": sd[f"{conv_key}.weight"]},
                 "bn": bn_p}, {"bn": bn_s})

    params["enc_pre"], stats["enc_pre"] = conv_bn("enc_pre.0", "enc_pre.1")
    params["encoder"], stats["encoder"] = [], []
    for i in range(num_encoder):
        p, s = conv_bn(f"encoder.{i}.0", f"encoder.{i}.1")
        params["encoder"].append(p)
        stats["encoder"].append(s)
    for ours, theirs in (("rf_pre", "dpt_pre"), ("rf_post", "dpt_post")):
        p, s = conv_bn(f"{theirs}.1", f"{theirs}.2")
        params[ours] = {"lin": {"weight": sd[f"{theirs}.0.weight"]},
                        **p}
        stats[ours] = s

    params["time_pe"] = {"weight": sd["pe"]}
    params["rf_blocks"], stats["rf_blocks"] = [], []
    for i in range(num_blocks):
        b = f"dpt_block.{i}"
        bp: Params = {}
        bs: Params = {}
        for which in ("time", "freq"):
            qkv: Params = {"weight": _maybe_wn(sd, f"{b}.{which}_attn.qkv")}
            if f"{b}.{which}_attn.qkv.bias" in sd:
                qkv["bias"] = sd[f"{b}.{which}_attn.qkv.bias"]
            norm_p, norm_s = _bn(sd, f"{b}.{which}_post_norm")
            bp[f"{which}_attn"] = {"qkv": qkv}
            bp[f"{which}_fc"] = {
                "weight": sd[f"{b}.{which}_fc.weight"]}
            bp[f"{which}_post_norm"] = norm_p
            bs[f"{which}_post_norm"] = norm_s
            if pre_norm:
                _, bs[f"{which}_pre_norm"] = _bn(sd, f"{b}.{which}_pre_norm",
                                                 affine=False)
        if f"{b}.pe" in sd:
            bp["pe"] = {"weight": sd[f"{b}.pe"]}
        params["rf_blocks"].append(bp)
        stats["rf_blocks"].append(bs)

    params["decoder"], stats["decoder"] = [], []
    for i in range(num_encoder):
        p1, s1 = conv_bn(f"decoder.{i}.0", f"decoder.{i}.1")
        p2, s2 = conv_bn(f"decoder.{i}.3", f"decoder.{i}.4")
        params["decoder"].append({"conv1": p1["conv"], "bn1": p1["bn"],
                                  "conv2": p2["conv"], "bn2": p2["bn"]})
        stats["decoder"].append({"bn1": s1["bn"], "bn2": s2["bn"]})
    p1, s1 = conv_bn("dec_post.0", "dec_post.1")
    convt: Params = {"weight": sd["dec_post.3.weight"],
                     "bias": sd["dec_post.3.bias"]}
    if "dec_post.3.scale" in sd:
        convt["scale"] = sd["dec_post.3.scale"]
    params["dec_post"] = {**p1, "convt": convt}
    stats["dec_post"] = s1
    return {"params": params, "stats": stats}


def _conv_wb(sd, key: str) -> Params:
    p: Params = {"weight": sd[f"{key}.weight"]}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def _lstm(sd, base: str, suffix: str = "_l0") -> Params:
    return {
        "weight_ih": sd[f"{base}.weight_ih{suffix}"],
        "weight_hh": sd[f"{base}.weight_hh{suffix}"],
        "bias_ih": sd[f"{base}.bias_ih{suffix}"],
        "bias_hh": sd[f"{base}.bias_hh{suffix}"],
    }


def convert_bsrnn(state_dict, num_layers: int, subbands: tp.Sequence[int],
                  affine: bool = True, bias: bool = True,
                  device: tp.Optional[torch.device] = None) -> Params:
    """BSRNN baseline (reference: models/bsrnn/model.py:262-460)."""
    sd = _StateDict(state_dict, device)
    params: Params = {"band_split": [], "layers": [], "mask_decoder": []}
    stats: Params = {"band_split": [], "layers": [], "mask_decoder": []}
    for i, _ in enumerate(subbands):
        bn_p, bn_s = _bn(sd, f"band_split.norm.{i}", affine=affine)
        params["band_split"].append(
            {"norm": bn_p, "fc": _conv_wb(sd, f"band_split.fc.{i}")})
        stats["band_split"].append({"norm": bn_s})
    for i in range(num_layers):
        nt_p, nt_s = _bn(sd, f"norm_time.{i}", affine=affine)
        nf_p, nf_s = _bn(sd, f"norm_freq.{i}", affine=affine)
        params["layers"].append({
            "norm_time": nt_p,
            "rnn_time": _lstm(sd, f"rnn_time.{i}"),
            "fc_time": _conv_wb(sd, f"fc_time.{i}"),
            "norm_freq": nf_p,
            "rnn_freq": {"fwd": _lstm(sd, f"rnn_freq.{i}"),
                         "bwd": _lstm(sd, f"rnn_freq.{i}", "_l0_reverse")},
            "fc_freq": _conv_wb(sd, f"fc_freq.{i}"),
        })
        stats["layers"].append({"norm_time": nt_s, "norm_freq": nf_s})
    for i, _ in enumerate(subbands):
        entry: Params = {}
        entry_s: Params = {}
        for which, name in (("mask", "mlp_mask"), ("residual", "mlp_residual")):
            bn_p, bn_s = _bn(sd, f"mask_decoder.{name}.{i}.0", affine=bias)
            entry[which] = {
                "norm": bn_p,
                "conv1": _conv_wb(sd, f"mask_decoder.{name}.{i}.1"),
                "conv2": _conv_wb(sd, f"mask_decoder.{name}.{i}.3"),
            }
            entry_s[which] = {"norm": bn_s}
        params["mask_decoder"].append(entry)
        stats["mask_decoder"].append(entry_s)
    return {"params": params, "stats": stats}


def convert_fspen(state_dict, num_blocks: int, groups: int,
                  n_channels: int = 3,
                  device: tp.Optional[torch.device] = None) -> Params:
    """FSPEN baseline (reference: models/fspen/model.py)."""
    sd = _StateDict(state_dict, device)
    params: Params = {}
    stats: Params = {}
    params["subband_encoder"] = [
        _conv_wb(sd, f"subband_encoder.conv{i + 1}.0") for i in range(5)]
    params["subband_decoder"] = [
        _conv_wb(sd, f"subband_decoder.lin{i + 1}.0") for i in range(5)]
    params["fullband_encoder"], stats["fullband_encoder"] = [], []
    for i in range(n_channels):
        bn_p, bn_s = _bn(sd, f"fullband_encoder.{i}.1")
        params["fullband_encoder"].append(
            {"conv": _conv_wb(sd, f"fullband_encoder.{i}.0"), "bn": bn_p})
        stats["fullband_encoder"].append({"bn": bn_s})
    params["fullband_encoder_post"] = _conv_wb(sd, "fullband_encoder_post")
    params["feature_merge"] = {"lin": _conv_wb(sd, "feature_merge.0"),
                               "conv": _conv_wb(sd, "feature_merge.2")}
    params["feature_split"] = {"conv": _conv_wb(sd, "feature_split.0"),
                               "lin": _conv_wb(sd, "feature_split.1")}
    params["dpe_blocks"], stats["dpe_blocks"] = [], []
    for i in range(num_blocks):
        b = f"dpe_blocks.{i}"
        params["dpe_blocks"].append({
            "intra_rnn": _bigru(sd, f"{b}.intra_rnn"),
            "intra_fc": _conv_wb(sd, f"{b}.intra_fc"),
            "intra_ln": {"weight": sd[f"{b}.intra_ln.weight"],
                         "bias": sd[f"{b}.intra_ln.bias"]},
            "inter_rnn": [_gru(sd, f"{b}.inter_rnn.inter_rnn.{g}")
                          for g in range(groups)],
            "inter_fc": [_conv_wb(sd, f"{b}.inter_rnn.inter_fc.{g}")
                         for g in range(groups)],
        })
        stats["dpe_blocks"].append({})
    params["fullband_decoder"], stats["fullband_decoder"] = [], []
    for i in range(n_channels):
        unit: Params = {"conv1": _conv_wb(sd, f"fullband_decoder.{i}.0"),
                        "convt": _conv_wb(sd, f"fullband_decoder.{i}.1")}
        st: Params = {}
        if f"fullband_decoder.{i}.2.running_mean" in sd:
            bn_p, bn_s = _bn(sd, f"fullband_decoder.{i}.2")
            unit["bn"] = bn_p
            st["bn"] = bn_s
        params["fullband_decoder"].append(unit)
        stats["fullband_decoder"].append(st)
    return {"params": params, "stats": stats}


def _cln(sd, key: str) -> Params:
    """CustomLayerNorm gamma/beta [1, C|1, 1, F] -> channels-last [F, C|1]."""
    g = sd[f"{key}.gamma"]
    b = sd[f"{key}.beta"]
    g = g.reshape(g.shape[1], g.shape[3]).T.contiguous()
    b = b.reshape(b.shape[1], b.shape[3]).T.contiguous()
    return {"gamma": g, "beta": b}


def convert_lisennet(state_dict, n_blocks: int = 2,
                     device: tp.Optional[torch.device] = None) -> Params:
    """LiSenNet baseline (reference: models/lisennet/model.py)."""
    sd = _StateDict(state_dict, device)
    P: Params = {}

    def prelu_w(key):
        return sd[f"{key}.weight"]

    P["encoder"] = {
        "conv_1": {"conv": _conv_wb(sd, "encoder.conv_1.0"),
                   "norm": _cln(sd, "encoder.conv_1.1"),
                   "act": prelu_w("encoder.conv_1.2")},
    }
    for name in ("conv_2", "conv_3", "conv_4"):
        P["encoder"][name] = {
            "low_conv": _conv_wb(sd, f"encoder.{name}.low_conv"),
            "high_conv": _conv_wb(sd, f"encoder.{name}.high_conv"),
            "norm": _cln(sd, f"encoder.{name}.norm"),
            "act": prelu_w(f"encoder.{name}.act"),
        }

    P["blocks"] = []
    for i in range(n_blocks):
        b = f"blocks.{i}"
        P["blocks"].append({
            "intra_norm": {
                "weight": sd[f"{b}.dp_rnn_attn.intra_norm.weight"],
                "bias": sd[f"{b}.dp_rnn_attn.intra_norm.bias"]},
            "intra_rnn": _bigru(sd, f"{b}.dp_rnn_attn.intra_rnn_attn.rnn"),
            "intra_fc": _conv_wb(sd, f"{b}.dp_rnn_attn.intra_rnn_attn.dense"),
            "inter_norm": {
                "weight": sd[f"{b}.dp_rnn_attn.inter_norm.weight"],
                "bias": sd[f"{b}.dp_rnn_attn.inter_norm.bias"]},
            "inter_rnn": _gru(sd, f"{b}.dp_rnn_attn.inter_rnn_attn.rnn"),
            "inter_fc": _conv_wb(sd, f"{b}.dp_rnn_attn.inter_rnn_attn.dense"),
            "glu": {
                "norm": _cln(sd, f"{b}.conv_glu.norm"),
                "fc1": _conv_wb(sd, f"{b}.conv_glu.fc1"),
                "dwconv": _conv_wb(sd, f"{b}.conv_glu.dwconv"),
                "fc2": _conv_wb(sd, f"{b}.conv_glu.fc2"),
            },
        })

    P["decoder"] = {
        "mask_conv": {"conv1": _conv_wb(sd, "decoder.mask_conv.0"),
                      "norm": _cln(sd, "decoder.mask_conv.1"),
                      "act": prelu_w("decoder.mask_conv.2"),
                      "conv2": _conv_wb(sd, "decoder.mask_conv.3")},
        "lsigmoid": {"slope": sd["decoder.lsigmoid.slope"]},
    }
    for name in ("up1", "up2", "up3"):
        P["decoder"][name] = {
            "low_conv": _conv_wb(sd, f"decoder.{name}.low_conv"),
            "high_conv": _conv_wb(sd, f"decoder.{name}.high_conv.conv"),
        }
    return {"params": P, "stats": {}}


def convert_checkpoint(
    ckpt_or_state_dict: tp.Mapping[str, tp.Any],
    model_name: str,
    model_kwargs: tp.Mapping[str, tp.Any],
    device: tp.Optional[torch.device] = None,
) -> Params:
    """Top-level entry: accepts either a full reference checkpoint dict
    ({"model": state_dict, ...}) or a bare state_dict, and returns the
    model's variables on `device` (the first CUDA card unless named;
    raises RuntimeError when there is none)."""
    sd = ckpt_or_state_dict
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    # strip a possible DDP "module." prefix
    sd = _StateDict({re.sub(r"^module\.", "", k): v for k, v in sd.items()},
                    device)
    n_enc = len(model_kwargs.get("kernel_size",
                                 model_kwargs.get("kernel_size_freq",
                                                  [8, 3, 3]))) - 1
    if model_name == "lisennet":
        return convert_lisennet(sd, n_blocks=model_kwargs.get("n_blocks", 2))
    if model_name == "fspen":
        dpe = model_kwargs.get("dpe_kwargs", {})
        return convert_fspen(
            sd, num_blocks=dpe.get("num_blocks", 3),
            groups=dpe.get("groups", 8),
            n_channels=len(model_kwargs.get("channels", [4, 16, 32])))
    if model_name == "bsrnn":
        from ..models.bsrnn import SUBBANDS_512

        return convert_bsrnn(
            sd, num_layers=model_kwargs.get("num_layers", 6),
            subbands=SUBBANDS_512,
            affine=model_kwargs.get("affine", True),
            bias=model_kwargs.get("bias", True))
    if model_name == "fastenhancer.dptransformer":
        cfg = model_kwargs.get("dpt_kwargs", {})
        return convert_fastenhancer_dpt(
            sd, num_blocks=cfg.get("num_blocks", 3), num_encoder=n_enc,
            pre_norm=cfg.get("pre_norm", False))
    if model_name == "fastenhancer.time_kernel":
        rf = model_kwargs.get("rnnformer_kwargs", {})
        out = convert_fastenhancer_default(
            sd, num_blocks=rf.get("num_blocks", 3), num_encoder=n_enc,
            pre_norm=rf.get("pre_norm", False))
        # 1x1 Conv2d weights [O,I,1,1] -> per-frame conv1d [O,I,1];
        # encoder/decoder causal convs keep their [O,I,kt,kf] 4-D shape.
        p = out["params"]
        for name in ("rf_pre", "rf_post"):
            w = p[name]["conv"]["weight"]
            p[name]["conv"]["weight"] = w.reshape(w.shape[0], w.shape[1], 1)
        for unit in p["decoder"]:
            w = unit["conv1"]["weight"]
            unit["conv1"]["weight"] = w.reshape(w.shape[0], w.shape[1], 1)
        return out
    if model_name in ("fastenhancer.default", "fastenhancer.conv_stft"):
        rf = model_kwargs.get("rnnformer_kwargs", {})
        return convert_fastenhancer_default(
            sd, num_blocks=rf.get("num_blocks", 3), num_encoder=n_enc,
            pre_norm=rf.get("pre_norm", False))
    if model_name == "fastenhancer.noncausal":
        rf = model_kwargs.get("rnnformer_kwargs", {})
        return convert_fastenhancer_noncausal(
            sd, num_blocks=rf.get("num_blocks", 3), num_encoder=n_enc,
            pre_norm=rf.get("pre_norm", False))
    if model_name == "fastenhancer.dprnn":
        dp = model_kwargs.get("dprnn_kwargs", {})
        return convert_fastenhancer_dprnn(
            sd, num_blocks=dp.get("num_blocks", 3), num_encoder=n_enc,
            pre_norm=dp.get("pre_norm", False))
    if model_name == "fastenhancer.ln":
        rf = model_kwargs.get("rnnformer_kwargs", {})
        return convert_fastenhancer_ln(
            sd, num_blocks=rf.get("num_blocks", 3), num_encoder=n_enc,
            pre_norm=rf.get("pre_norm", False))
    raise NotImplementedError(f"no converter for model {model_name!r} yet")
