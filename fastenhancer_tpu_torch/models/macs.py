"""Analytic MACs-per-second calculators: the port's copy of
fastenhancer_tpu/models/macs.py, calculator for calculator.

Rebuild of the reference's per-model macs.py scripts (reference:
models/fastenhancer/default/macs.py:17-87 et al.) as one module of pure
functions over model_kwargs: MACs are counted per second of audio
(T = sr / hop frames). StridedConv MACs follow the reference's accounting
(Cin x Cout x K x T / S, reference: models/fastenhancer/default/model.py:16-18).
The config is read with the port's YAML reader (`utils/yaml_subset.py`),
so no pyyaml is needed.

    python -m fastenhancer_tpu_torch.models.macs configs/fastenhancer/t.yaml
"""
from __future__ import annotations

import typing as tp


def fastenhancer_macs(hp: tp.Mapping[str, tp.Any], sr: int = 16_000
                      ) -> tp.Dict[str, float]:
    """fastenhancer.default / conv_stft / noncausal (bi-GRU doubles the RNN)."""
    rf = hp["rnnformer_kwargs"]
    f_input = hp["n_fft"] // 2
    t = sr / hp["hop_size"]
    c1, c2 = hp["channels"], rf["channels"]
    f1 = f_input // hp["stride"]
    f2 = rf["freq"]
    k_blocks = rf["num_blocks"]
    ks = list(hp["kernel_size"])
    bidir = 2 if hp.get("_bidirectional") else 1

    out: tp.Dict[str, float] = {}
    out["pre_encoder"] = 2 * c1 * ks[0] * f1 * t
    out["encoder"] = sum(c1 ** 2 * k * f1 * t for k in ks[1:])
    out["pre_rnnformer"] = (f1 * f2 * c1 + c1 * c2 * f2) * t
    rnnformer = 0.0
    for _ in range(k_blocks):
        rnnformer += bidir * c2 ** 2 * 6 * f2 * t          # GRU (3 gates x2)
        rnnformer += bidir * c2 * c2 * f2 * t              # rnn fc
        rnnformer += (c2 * c2 * 3 * f2 + f2 * c2 * f2
                      + f2 * f2 * c2) * t                  # MHSA qkv+scores+out
        rnnformer += c2 * c2 * f2 * t                      # attn fc
    out["rnnformer"] = rnnformer
    out["post_rnnformer"] = (f2 * f1 * c2 + c2 * c1 * f1) * t
    out["decoder"] = sum((2 * c1 ** 2 * f1 + c1 ** 2 * k * f1) * t
                         for k in ks[:0:-1])
    out["post_decoder"] = (2 * c1 ** 2 * f1 + c1 * 2 * ks[0] * f1) * t
    out["total"] = sum(out.values())
    return out


def dprnn_macs(hp, sr: int = 16_000) -> tp.Dict[str, float]:
    dp = hp["dprnn_kwargs"]
    shim = dict(hp)
    shim["rnnformer_kwargs"] = dict(num_blocks=dp["num_blocks"],
                                    channels=dp["channels"],
                                    freq=dp["freq"], num_heads=4)
    out = fastenhancer_macs(shim, sr)
    # replace the MHSA part with the bidirectional freq GRU
    t = sr / hp["hop_size"]
    c2, cf, f2 = dp["channels"], dp["channels_frnn"], dp["freq"]
    rnnformer = 0.0
    for _ in range(dp["num_blocks"]):
        rnnformer += c2 ** 2 * 6 * f2 * t        # time GRU
        rnnformer += c2 * c2 * f2 * t            # trnn fc
        rnnformer += 2 * (c2 * cf + cf * cf) * 3 * f2 * t  # bi freq GRU
        rnnformer += 2 * cf * c2 * f2 * t        # frnn fc (2cf -> c2)
    out["rnnformer"] = rnnformer
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def bsrnn_macs(hp, sr: int = 16_000) -> tp.Dict[str, float]:
    from .bsrnn import SUBBANDS_512

    c = hp["num_channels"]
    layers = hp["num_layers"]
    t = sr / hp["hop_size"]
    n_bands = len(SUBBANDS_512)
    out: tp.Dict[str, float] = {}
    out["band_split"] = sum(2 * sub * c for sub in SUBBANDS_512) * t
    h = 2 * c
    per_layer = (
        n_bands * (c * h + h * h) * 4          # time LSTM (4 gates)
        + n_bands * h * c                      # time fc
        + n_bands * 2 * ((c * h + h * h) * 4)  # bi freq LSTM
        + n_bands * 4 * h * c / 2              # freq fc (4C*... approx 2h->c)
    )
    out["layers"] = layers * per_layer * t
    out["mask_decoder"] = sum(
        2 * (c * 4 * c + 4 * c * sub * 4) for sub in SUBBANDS_512) * t
    out["total"] = sum(out.values())
    return out


def fspen_macs(hp, sr: int = 16_000) -> tp.Dict[str, float]:
    from .fspen import SUB_ENC, SUB_DEC

    dpe = hp["dpe_kwargs"]
    t = sr / hp["hop_size"]
    chans = list(hp["channels"])
    ks = list(hp["kernel_size"])
    strides = list(hp["stride"])
    c_out = chans[-1]
    out: tp.Dict[str, float] = {}
    out["subband_encoder"] = sum(
        c_out * k * ((e - s + pl + pr - k) // st + 1)
        for (s, e, pl, pr, k, st) in SUB_ENC) * t
    out["subband_decoder"] = sum(
        (e - s + pad) * 2 * c_out * o
        for (s, e, pad, o, _, _) in SUB_DEC) * t
    f = 257
    fb = 0.0
    cin = 2
    for c, k, s in zip(chans, ks, strides):
        f = f // s
        fb += cin * c * k * f
        cin = c
    out["fullband_encoder"] = fb * t
    c2, f2, g = dpe["channels"], dpe["freq"], dpe["groups"]
    out["feature_merge"] = (64 * f2 * c_out + c_out * c2 * f2) * t
    dpe_macs = 0.0
    for _ in range(dpe["num_blocks"]):
        dpe_macs += 2 * c2 ** 2 * 6 * f2        # intra bi GRU
        dpe_macs += 2 * c2 * c2 * f2            # intra fc
        dpe_macs += g * (c2 ** 2 * 6 * (f2 // g))  # inter grouped GRU
        dpe_macs += c2 * c2 * f2                # inter fc
    out["dpe"] = dpe_macs * t
    out["feature_split"] = (c2 * c_out * f2 + f2 * 64 * c_out) * t
    out["fullband_decoder"] = out["fullband_encoder"] * 2  # + 1x1 merges
    out["total"] = sum(out.values())
    return out


def lisennet_macs(hp, sr: int = 16_000) -> tp.Dict[str, float]:
    c = hp["num_channels"]
    t = sr / hp["hop_size"]
    f = 257
    out: tp.Dict[str, float] = {}
    out["encoder"] = (3 * (c // 4) * f
                      + (c // 4) * (c // 2) * (2 * 3) * (f // 2)
                      + (c // 2) * (3 * c // 4) * (2 * 3) * (f // 4)
                      + (3 * c // 4) * c * (2 * 3) * (f // 8)) * t
    f2 = f // 8
    hdim = c // 2 * 3
    blocks = 0.0
    for _ in range(hp["n_blocks"]):
        blocks += 2 * (c * (hdim // 2) + (hdim // 2) ** 2) * 3 * f2
        blocks += hdim * c * f2
        blocks += (c * hdim + hdim * hdim) * 3 * f2
        blocks += hdim * c * f2
        blocks += (c * 4 * c + 2 * c * 9 + 2 * c * c) * f2  # ConvGLU
    out["blocks"] = blocks * t
    out["decoder"] = out["encoder"] * 2
    out["total"] = sum(out.values())
    return out


CALCULATORS = {
    "fastenhancer.default": fastenhancer_macs,
    "fastenhancer.conv_stft": fastenhancer_macs,
    "fastenhancer.ln": fastenhancer_macs,
    "fastenhancer.noncausal": lambda hp, sr=16_000: fastenhancer_macs(
        {**hp, "_bidirectional": True}, sr),
    "fastenhancer.dprnn": dprnn_macs,
    "bsrnn": bsrnn_macs,
    "fspen": fspen_macs,
    "lisennet": lisennet_macs,
}


def macs_for_config(config_path: str) -> tp.Dict[str, float]:
    from ..utils import yaml_subset

    with open(config_path, encoding="utf-8") as f:
        cfg = yaml_subset.load(f.read())
    fn = CALCULATORS.get(cfg["model"])
    if fn is None:
        raise ValueError(f"no MACs calculator for {cfg['model']}")
    return fn(cfg["model_kwargs"], cfg["data"]["sampling_rate"])


if __name__ == "__main__":
    import sys

    path = sys.argv[1] if len(sys.argv) > 1 else "configs/fastenhancer/t.yaml"
    for name, macs in macs_for_config(path).items():
        print(f"{name:>16}: {macs / 1e6:8.1f}M")
