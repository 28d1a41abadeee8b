"""A model's {"params", "stats"} tree -> the reference PyTorch state dict.

The inverse of the key map in `utils/convert.py` (both packages'), family
by family: what `convert_checkpoint` reads is what this writes, so a tree
written here and converted back comes out equal leaf for leaf. Weight-norm
{"g", "v"} leaves become `parametrizations.<name>.original0/1` pairs, plain
weights `<name>`; BatchNorm statistics become `running_mean` /
`running_var`. Leaves pass through as they are (numpy arrays or tensors),
except the time_kernel ablation's 1x1 convs and LiSenNet's CustomLayerNorm
terms, which take back their reference shapes.

Imports neither jax nor the JAX package (nor the port), so `chip_smoke.py`
uses it on the card too:

    sd = reference_state_dict(variables, "fastenhancer.default")
"""
from __future__ import annotations

import typing as tp

Tree = tp.Dict[str, tp.Any]


class _Writer:
    def __init__(self):
        self.sd: tp.Dict[str, tp.Any] = {}

    def put(self, key: str, leaf: tp.Any) -> None:
        if key in self.sd:
            raise KeyError(f"{key} written twice")
        self.sd[key] = leaf

    def wn(self, base: str, name: str, leaf: tp.Any) -> None:
        """A weight, as its weight-norm pair where the tree holds {g, v}."""
        if isinstance(leaf, dict):
            self.put(f"{base}.parametrizations.{name}.original0", leaf["g"])
            self.put(f"{base}.parametrizations.{name}.original1", leaf["v"])
        else:
            self.put(f"{base}.{name}", leaf)

    def bn(self, prefix: str, params: tp.Optional[Tree], stats: Tree) -> None:
        if params is not None:
            self.put(f"{prefix}.weight", params["weight"])
            self.put(f"{prefix}.bias", params["bias"])
        self.put(f"{prefix}.running_mean", stats["mean"])
        self.put(f"{prefix}.running_var", stats["var"])

    def conv_bn(self, conv_key: str, bn_key: str, p: Tree, s: Tree) -> None:
        self.put(f"{conv_key}.weight", p["conv"]["weight"])
        self.bn(bn_key, p["bn"], s["bn"])

    def wb(self, key: str, p: Tree) -> None:
        """A layer's weight and, where it has one, its bias."""
        self.put(f"{key}.weight", p["weight"])
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def rnn(self, base: str, p: Tree, suffix: str = "_l0") -> None:
        """A GRU or LSTM layer's four tensors (weights weight-normed where
        the tree holds pairs)."""
        self.wn(base, f"weight_ih{suffix}", p["weight_ih"])
        self.wn(base, f"weight_hh{suffix}", p["weight_hh"])
        self.put(f"{base}.bias_ih{suffix}", p["bias_ih"])
        self.put(f"{base}.bias_hh{suffix}", p["bias_hh"])

    def birnn(self, base: str, p: Tree) -> None:
        self.rnn(base, p["fwd"], "_l0")
        self.rnn(base, p["bwd"], "_l0_reverse")

    def qkv(self, base: str, p: Tree) -> None:
        self.wn(base, "weight", p["weight"])
        if "bias" in p:
            self.put(f"{base}.bias", p["bias"])

    def dec_post_convt(self, p: Tree) -> None:
        for k in ("weight", "bias", "scale"):
            if k in p:
                self.put(f"dec_post.3.{k}", p[k])


def _encoder_decoder(w: _Writer, P: Tree, S: Tree) -> None:
    """The FastEnhancer encoder/decoder around the blocks (BN forms)."""
    w.conv_bn("enc_pre.0", "enc_pre.1", P["enc_pre"], S["enc_pre"])
    for i, (p, s) in enumerate(zip(P["encoder"], S["encoder"])):
        w.conv_bn(f"encoder.{i}.0", f"encoder.{i}.1", p, s)
    for i, (p, s) in enumerate(zip(P["decoder"], S["decoder"])):
        w.put(f"decoder.{i}.0.weight", p["conv1"]["weight"])
        w.bn(f"decoder.{i}.1", p["bn1"], s["bn1"])
        w.put(f"decoder.{i}.3.weight", p["conv2"]["weight"])
        w.bn(f"decoder.{i}.4", p["bn2"], s["bn2"])
    w.conv_bn("dec_post.0", "dec_post.1", P["dec_post"], S["dec_post"])
    w.dec_post_convt(P["dec_post"]["convt"])


def _pre_post(w: _Writer, P: Tree, S: Tree, theirs: tp.Tuple[str, str]
              ) -> None:
    for ours, name in zip(("rf_pre", "rf_post"), theirs):
        w.put(f"{name}.0.weight", P[ours]["lin"]["weight"])
        w.conv_bn(f"{name}.1", f"{name}.2", P[ours], S[ours])


def _fastenhancer(w: _Writer, P: Tree, S: Tree, bidirectional: bool) -> None:
    _encoder_decoder(w, P, S)
    _pre_post(w, P, S, ("rf_pre", "rf_post"))
    for i, (p, s) in enumerate(zip(P["rf_blocks"], S["rf_blocks"])):
        b = f"rf_block.{i}"
        if bidirectional:
            w.birnn(f"{b}.rnn", p["rnn"])
        else:
            w.rnn(f"{b}.rnn", p["rnn"])
        w.put(f"{b}.rnn_fc.weight", p["rnn_fc"]["weight"])
        w.bn(f"{b}.rnn_post_norm", p["rnn_post_norm"], s["rnn_post_norm"])
        w.qkv(f"{b}.attn.qkv", p["attn"]["qkv"])
        w.put(f"{b}.attn_fc.weight", p["attn_fc"]["weight"])
        w.bn(f"{b}.attn_post_norm", p["attn_post_norm"], s["attn_post_norm"])
        for norm in ("rnn_pre_norm", "attn_pre_norm"):
            if norm in s:
                w.bn(f"{b}.{norm}", None, s[norm])
        if "pe" in p:
            w.put(f"{b}.pe", p["pe"]["weight"])


def _time_kernel(w: _Writer, P: Tree, S: Tree) -> None:
    """The default layout, its 1x1 convs as Conv2d weights [O, I, 1, 1]."""
    def conv2d(leaf):
        return leaf.reshape(tuple(leaf.shape) + (1,))

    P = dict(P)
    for name in ("rf_pre", "rf_post"):
        P[name] = dict(P[name], conv={"weight": conv2d(
            P[name]["conv"]["weight"])})
    P["decoder"] = [dict(u, conv1={"weight": conv2d(u["conv1"]["weight"])})
                    for u in P["decoder"]]
    _fastenhancer(w, P, S, bidirectional=False)


def _dprnn(w: _Writer, P: Tree, S: Tree) -> None:
    _encoder_decoder(w, P, S)
    _pre_post(w, P, S, ("dprnn_pre", "dprnn_post"))
    for i, (p, s) in enumerate(zip(P["rf_blocks"], S["rf_blocks"])):
        b = f"dprnn_block.{i}"
        w.rnn(f"{b}.trnn", p["trnn"])
        w.put(f"{b}.trnn_fc.weight", p["trnn_fc"]["weight"])
        w.bn(f"{b}.trnn_post_norm", p["trnn_post_norm"], s["trnn_post_norm"])
        w.birnn(f"{b}.frnn", p["frnn"])
        w.put(f"{b}.frnn_fc.weight", p["frnn_fc"]["weight"])
        w.bn(f"{b}.frnn_post_norm", p["frnn_post_norm"], s["frnn_post_norm"])
        for norm in ("trnn_pre_norm", "frnn_pre_norm"):
            if norm in s:
                w.bn(f"{b}.{norm}", None, s[norm])


def _dpt(w: _Writer, P: Tree, S: Tree) -> None:
    _encoder_decoder(w, P, S)
    _pre_post(w, P, S, ("dpt_pre", "dpt_post"))
    w.put("pe", P["time_pe"]["weight"])
    for i, (p, s) in enumerate(zip(P["rf_blocks"], S["rf_blocks"])):
        b = f"dpt_block.{i}"
        for which in ("time", "freq"):
            w.qkv(f"{b}.{which}_attn.qkv", p[f"{which}_attn"]["qkv"])
            w.put(f"{b}.{which}_fc.weight", p[f"{which}_fc"]["weight"])
            w.bn(f"{b}.{which}_post_norm", p[f"{which}_post_norm"],
                 s[f"{which}_post_norm"])
            if f"{which}_pre_norm" in s:
                w.bn(f"{b}.{which}_pre_norm", None, s[f"{which}_pre_norm"])
        if "pe" in p:
            w.put(f"{b}.pe", p["pe"]["weight"])


def _ln(w: _Writer, P: Tree) -> None:
    """The ln ablation: GroupNorm/LayerNorm affines, convs with biases."""
    def conv_gn(conv_key, gn_key, conv, gn):
        w.wb(conv_key, conv)
        w.wb(gn_key, gn)

    conv_gn("enc_pre.0", "enc_pre.1", P["enc_pre"]["conv"],
            P["enc_pre"]["gn"])
    for i, p in enumerate(P["encoder"]):
        conv_gn(f"encoder.{i}.0", f"encoder.{i}.1", p["conv"], p["gn"])
    for name in ("rf_pre", "rf_post"):
        w.put(f"{name}.0.weight", P[name]["lin"]["weight"])
        conv_gn(f"{name}.1", f"{name}.2", P[name]["conv"], P[name]["gn"])
    for i, p in enumerate(P["rf_blocks"]):
        b = f"rf_block.{i}"
        w.rnn(f"{b}.rnn", p["rnn"])
        w.put(f"{b}.rnn_fc.weight", p["rnn_fc"]["weight"])
        w.wb(f"{b}.rnn_post_norm", p["rnn_post_norm"]["ln"])
        w.qkv(f"{b}.attn.qkv", p["attn"]["qkv"])
        w.put(f"{b}.attn_fc.weight", p["attn_fc"]["weight"])
        w.wb(f"{b}.attn_post_norm", p["attn_post_norm"]["ln"])
        if "pe" in p:
            w.put(f"{b}.pe", p["pe"]["weight"])
    for i, p in enumerate(P["decoder"]):
        conv_gn(f"decoder.{i}.0", f"decoder.{i}.1", p["conv1"], p["gn1"])
        conv_gn(f"decoder.{i}.3", f"decoder.{i}.4", p["conv2"], p["gn2"])
    conv_gn("dec_post.0", "dec_post.1", P["dec_post"]["conv"],
            P["dec_post"]["gn"])
    w.dec_post_convt(P["dec_post"]["convt"])


def _bsrnn(w: _Writer, P: Tree, S: Tree) -> None:
    for i, (p, s) in enumerate(zip(P["band_split"], S["band_split"])):
        w.bn(f"band_split.norm.{i}", p["norm"], s["norm"])
        w.wb(f"band_split.fc.{i}", p["fc"])
    for i, (p, s) in enumerate(zip(P["layers"], S["layers"])):
        w.bn(f"norm_time.{i}", p["norm_time"], s["norm_time"])
        w.rnn(f"rnn_time.{i}", p["rnn_time"])
        w.wb(f"fc_time.{i}", p["fc_time"])
        w.bn(f"norm_freq.{i}", p["norm_freq"], s["norm_freq"])
        w.birnn(f"rnn_freq.{i}", p["rnn_freq"])
        w.wb(f"fc_freq.{i}", p["fc_freq"])
    for i, (p, s) in enumerate(zip(P["mask_decoder"], S["mask_decoder"])):
        for which, name in (("mask", "mlp_mask"), ("residual", "mlp_residual")):
            base = f"mask_decoder.{name}.{i}"
            w.bn(f"{base}.0", p[which]["norm"], s[which]["norm"])
            w.wb(f"{base}.1", p[which]["conv1"])
            w.wb(f"{base}.3", p[which]["conv2"])


def _fspen(w: _Writer, P: Tree, S: Tree) -> None:
    for i, p in enumerate(P["subband_encoder"]):
        w.wb(f"subband_encoder.conv{i + 1}.0", p)
    for i, p in enumerate(P["subband_decoder"]):
        w.wb(f"subband_decoder.lin{i + 1}.0", p)
    for i, (p, s) in enumerate(zip(P["fullband_encoder"],
                                   S["fullband_encoder"])):
        w.wb(f"fullband_encoder.{i}.0", p["conv"])
        w.bn(f"fullband_encoder.{i}.1", p["bn"], s["bn"])
    w.wb("fullband_encoder_post", P["fullband_encoder_post"])
    w.wb("feature_merge.0", P["feature_merge"]["lin"])
    w.wb("feature_merge.2", P["feature_merge"]["conv"])
    w.wb("feature_split.0", P["feature_split"]["conv"])
    w.wb("feature_split.1", P["feature_split"]["lin"])
    for i, p in enumerate(P["dpe_blocks"]):
        b = f"dpe_blocks.{i}"
        w.birnn(f"{b}.intra_rnn", p["intra_rnn"])
        w.wb(f"{b}.intra_fc", p["intra_fc"])
        w.wb(f"{b}.intra_ln", p["intra_ln"])
        for g, (rnn, fc) in enumerate(zip(p["inter_rnn"], p["inter_fc"])):
            w.rnn(f"{b}.inter_rnn.inter_rnn.{g}", rnn)
            w.wb(f"{b}.inter_rnn.inter_fc.{g}", fc)
    for i, (p, s) in enumerate(zip(P["fullband_decoder"],
                                   S["fullband_decoder"])):
        w.wb(f"fullband_decoder.{i}.0", p["conv1"])
        w.wb(f"fullband_decoder.{i}.1", p["convt"])
        if "bn" in p:
            w.bn(f"fullband_decoder.{i}.2", p["bn"], s["bn"])


def _lisennet(w: _Writer, P: Tree) -> None:
    def cln(key, p):
        """channels-last [F, C|1] -> CustomLayerNorm's [1, C|1, 1, F]."""
        for ours, theirs in (("gamma", "gamma"), ("beta", "beta")):
            t = p[ours].T
            w.put(f"{key}.{theirs}", t.reshape((1, t.shape[0], 1, t.shape[1])))

    enc = P["encoder"]
    w.wb("encoder.conv_1.0", enc["conv_1"]["conv"])
    cln("encoder.conv_1.1", enc["conv_1"]["norm"])
    w.put("encoder.conv_1.2.weight", enc["conv_1"]["act"])
    for name in ("conv_2", "conv_3", "conv_4"):
        w.wb(f"encoder.{name}.low_conv", enc[name]["low_conv"])
        w.wb(f"encoder.{name}.high_conv", enc[name]["high_conv"])
        cln(f"encoder.{name}.norm", enc[name]["norm"])
        w.put(f"encoder.{name}.act.weight", enc[name]["act"])
    for i, p in enumerate(P["blocks"]):
        b = f"blocks.{i}"
        w.wb(f"{b}.dp_rnn_attn.intra_norm", p["intra_norm"])
        w.birnn(f"{b}.dp_rnn_attn.intra_rnn_attn.rnn", p["intra_rnn"])
        w.wb(f"{b}.dp_rnn_attn.intra_rnn_attn.dense", p["intra_fc"])
        w.wb(f"{b}.dp_rnn_attn.inter_norm", p["inter_norm"])
        w.rnn(f"{b}.dp_rnn_attn.inter_rnn_attn.rnn", p["inter_rnn"])
        w.wb(f"{b}.dp_rnn_attn.inter_rnn_attn.dense", p["inter_fc"])
        cln(f"{b}.conv_glu.norm", p["glu"]["norm"])
        for k in ("fc1", "dwconv", "fc2"):
            w.wb(f"{b}.conv_glu.{k}", p["glu"][k])
    dec = P["decoder"]
    w.wb("decoder.mask_conv.0", dec["mask_conv"]["conv1"])
    cln("decoder.mask_conv.1", dec["mask_conv"]["norm"])
    w.put("decoder.mask_conv.2.weight", dec["mask_conv"]["act"])
    w.wb("decoder.mask_conv.3", dec["mask_conv"]["conv2"])
    w.put("decoder.lsigmoid.slope", dec["lsigmoid"]["slope"])
    for name in ("up1", "up2", "up3"):
        w.wb(f"decoder.{name}.low_conv", dec[name]["low_conv"])
        w.wb(f"decoder.{name}.high_conv.conv", dec[name]["high_conv"])


def reference_state_dict(variables: Tree, model_name: str
                         ) -> tp.Dict[str, tp.Any]:
    """The reference state dict of `model_name` that holds `variables`
    (an unfolded {"params", "stats"} tree; the tree fixes every count)."""
    P, S = variables["params"], variables["stats"]
    w = _Writer()
    if model_name in ("fastenhancer.default", "fastenhancer.conv_stft"):
        _fastenhancer(w, P, S, bidirectional=False)
    elif model_name == "fastenhancer.noncausal":
        _fastenhancer(w, P, S, bidirectional=True)
    elif model_name == "fastenhancer.time_kernel":
        _time_kernel(w, P, S)
    elif model_name == "fastenhancer.dprnn":
        _dprnn(w, P, S)
    elif model_name == "fastenhancer.dptransformer":
        _dpt(w, P, S)
    elif model_name == "fastenhancer.ln":
        _ln(w, P)
    elif model_name == "bsrnn":
        _bsrnn(w, P, S)
    elif model_name == "fspen":
        _fspen(w, P, S)
    elif model_name == "lisennet":
        _lisennet(w, P)
    else:
        raise NotImplementedError(f"no reference layout for {model_name!r}")
    return w.sd


def reference_checkpoint(variables: Tree, model_name: str
                         ) -> tp.Dict[str, tp.Any]:
    """The state dict as a DDP-trained reference checkpoint holds it:
    {"model": {"module." + key: tensor}}."""
    sd = reference_state_dict(variables, model_name)
    return {"model": {"module." + k: v for k, v in sd.items()}}
