"""Programmatic config builder — the port's copy of
fastenhancer_tpu/configs/builder.py, table for table.

The reference ships 41 hand-written yaml files (reference: configs/**). Here
the same recipe space is generated from compact tables: a per-group base
template deep-merged with per-size deltas, then written to `configs/**.yaml`
by `python -m fastenhancer_tpu_torch.scripts.gen_configs` (byte for byte
what scripts/gen_configs.py writes). Generated files load through
`fastenhancer_tpu_torch.utils.hparams.get_hparams` exactly like reference
files do (same schema, same keys), and reference yaml files also load
unchanged. Nothing here imports the JAX package: the card has neither JAX
nor pyyaml.

Deviation from the reference: dataset paths are rooted at `data/` instead of
the reference author's absolute home paths; point `data/` (or -p overrides)
at your corpora.

Recipe values transcribed from: configs/fastenhancer/{t,s,b,m,l}.yaml,
configs/fastenhancer_dns/*, configs/fastenhancer_48khz/*, configs/ablation/*,
configs/others{,_dns}/*.
"""
from __future__ import annotations

import copy
import typing as tp

Cfg = tp.Dict[str, tp.Any]


def deep_merge(base: Cfg, *overrides: Cfg) -> Cfg:
    out = copy.deepcopy(base)
    for ov in overrides:
        stack = [(out, ov)]
        while stack:
            dst, src = stack.pop()
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    stack.append((dst[k], v))
                else:
                    dst[k] = copy.deepcopy(v)
    return out


# ---------------------------------------------------------------------------
# Data sections
# ---------------------------------------------------------------------------

_VBD16 = "data/voicebank-demand/16k"
_VBD48 = "data/voicebank-demand/48k"
_VBD24 = "data/voicebank-demand/24k"
_VBDLOG = "data/voicebank-demand/logfiles"
_DNS16 = "data/DNS-Challenge/16khz"
_DNS24 = "data/DNS-Challenge/24khz"
_DNSTEST16 = f"{_DNS16}/testset_synthetic_interspeech2020/no_reverb"

DATA_VBD16 = {
    "dataset": "NoiseSuppression",
    "train": {
        "clean_dir": f"{_VBD16}/clean_trainset_28spk_wav",
        "noisy_dir": f"{_VBD16}/noisy_trainset_28spk_wav",
        "metadata": f"{_VBDLOG}/log_trainset_28spk.txt",
        "segment_size": 32000,
    },
    "valid": {
        "clean_dir": f"{_VBD16}/clean_testset_wav",
        "noisy_dir": f"{_VBD16}/noisy_testset_wav",
        "metadata": f"{_VBDLOG}/log_testset.txt",
        "segment_size": 32000,
    },
    "infer": {
        "clean_dir": f"{_VBD16}/clean_testset_wav",
        "noisy_dir": f"{_VBD16}/noisy_testset_wav",
        "files": ["p232_013", "p257_090", "p232_010", "p257_042"],
    },
    "pesq": {
        "clean_dir": f"{_VBD16}/clean_testset_wav",
        "noisy_dir": f"{_VBD16}/noisy_testset_wav",
        "metadata": f"{_VBDLOG}/log_testset.txt",
        "segment_size": None,
    },
    "sampling_rate": 16000,
}

_SNR_MIXER = {
    "segmental_snr": True,
    "rms_window_size": 0.1,
    "activity_threshold": -40,
    "dataloader_rms": -20,
    "snr_range": [-5, 20],
    "noisy_rms_range": [-25, -10],
    "clean_activity_threshold": 0.3,
    "noise_activity_threshold": 0.0,
}

DATA_DNS16 = {
    "dataset": {"train": "NoiseSuppressionOnTheFly", "valid": "NoiseSuppression",
                "infer": "NoiseSuppression", "pesq": "NoiseSuppression"},
    "train": {"clean_dir": f"{_DNS16}/clean", "noise_dir": f"{_DNS16}/noise",
              "segment_size": 32000, "length": 16384},
    "valid": {"clean_dir": f"{_DNSTEST16}/clean",
              "noisy_dir": f"{_DNSTEST16}/noisy", "segment_size": 32000},
    "infer": {"clean_dir": f"{_DNSTEST16}/clean",
              "noisy_dir": f"{_DNSTEST16}/noisy",
              "files": ["002", "066", "063", "053"]},
    "pesq": {"clean_dir": f"{_DNSTEST16}/clean",
             "noisy_dir": f"{_DNSTEST16}/noisy", "segment_size": None},
    "sampling_rate": 16000,
    "reverb_prob": 0.0,
    "silence_length": 0.0,
    "snr_mixer": _SNR_MIXER,
}

DATA_48K = {
    "dataset": {"train": "NoiseSuppressionOnTheFly", "valid": "NoiseSuppression",
                "infer": "NoiseSuppression", "pesq": "NoiseSuppression"},
    "train": {"clean_dir": "data/se_48khz/clean",
              "noise_dir": "data/se_48khz/noise",
              "segment_size": 96000, "length": 16384},
    "valid": {"clean_dir": f"{_VBD48}/clean_testset_wav",
              "noisy_dir": f"{_VBD48}/noisy_testset_wav",
              "segment_size": 96000},
    "infer": {"clean_dir": f"{_VBD48}/clean_testset_wav",
              "noisy_dir": f"{_VBD48}/noisy_testset_wav",
              "files": ["p232_013", "p257_090", "p232_010", "p257_042"]},
    "pesq": {"clean_dir": f"{_VBD48}/clean_testset_wav",
             "noisy_dir": f"{_VBD48}/noisy_testset_wav", "segment_size": None},
    "sampling_rate": 48000,
    "reverb_prob": 0.0,
    "silence_length": 0.0,
    "snr_mixer": _SNR_MIXER,
    "dynamic_lpf": {"p_lpf": 0.5, "kernel_size": 127,
                    "target_sr_list": [8000, 16000, 22050, 24000, 32000, 44100]},
}


# ---------------------------------------------------------------------------
# Train sections
# ---------------------------------------------------------------------------

LOSSES_VBD = {
    "mag_mse": {"weight": 0.3},
    "complex_mse": {"weight": 0.2},
    "consistency": {"weight": 0.3, "compression": 0.3},
    "wav_l1": {"weight": 0.2},
    "pesq": {"weight": 1.0e-3},
}
LOSSES_NO_PESQ = {k: v for k, v in LOSSES_VBD.items() if k != "pesq"}


def fe_optimizer_groups(prefix: str = "rf", rnn_g: str = r"rf_block\.\d\.rnn",
                        fc: str = "(rnn|attn)_fc") -> list:
    """The fastenhancer-family AdamP projection routing
    (reference: configs/fastenhancer/t.yaml:88-109)."""
    return [
        {"regex_list": [rnn_g + r"\.parametrizations.+original0$",
                        r"dec_post\.3\.scale"],
         "weight_decay": 0, "projection": "disabled"},
        {"regex_list": [r".+parametrizations.+original1$",
                        r"enc_pre\.0\.weight",
                        r"encoder\.\d\.0\.weight",
                        prefix + r"_(pre|post)\.1\.weight",
                        fc + r"\.weight",
                        r"decoder\.\d\.[03]\.weight",
                        r"dec_post\.0\.weight"],
         "projection": "channelwise"},
        {"regex_list": [prefix + r"_(pre|post)\.0\.weight",
                        r"dec_post\.3\.weight"],
         "projection": "layerwise"},
    ]


def train_section(
    losses: Cfg,
    optimizer: str = "AdamP",
    optimizer_groups: tp.Optional[list] = ...,
    batch_size: int = 64,
    num_workers: int = 2,
    fp16: bool = True,
    plot: bool = False,
    lr: float = 2.0e-3,
    explicit_projection: bool = True,
) -> Cfg:
    kwargs: Cfg = {"lr": lr, "weight_decay": 0.01, "betas": [0.95, 0.999]}
    if optimizer == "AdamP":
        kwargs["wd_ratio"] = 1.0
        if explicit_projection:
            kwargs["projection"] = "auto"
    out: Cfg = {
        "test": False,
        "batch_size": batch_size,
        "print_interval": 1,
        "max_epochs": 500,
        "save_interval": 20,
        "fp16": fp16,
        "num_workers": num_workers,
        "persistent_workers": True,
        "clip_grad": None,
        "seed": 1,
        "plot_param_and_grad": plot,
        "losses": copy.deepcopy(losses),
        "optimizer": optimizer,
        "optimizer_kwargs": kwargs,
        "scheduler": "CosineAnnealingWarmup",
        "scheduler_kwargs": {"warmup_iterations": 500, "eta_min": 1.0e-6,
                             "warn": False},
    }
    if optimizer_groups is ...:
        out["optimizer_groups"] = fe_optimizer_groups()
    elif optimizer_groups is not None:
        out["optimizer_groups"] = optimizer_groups
    return out


def tail_sections(pesq_bs: int = 16, executors: int = 16,
                  valid_extra: tp.Optional[Cfg] = None,
                  infer_extra: tp.Optional[Cfg] = None) -> Cfg:
    return {
        "valid": {"batch_size": 64, **(valid_extra or {})},
        "infer": {"batch_size": 1, "interval": 20, **(infer_extra or {})},
        "pesq": {"batch_size": pesq_bs, "num_workers": 0,
                 "num_workers_executor": executors, "interval": 20,
                 "metrics_to_calculate": {"pesq": True, "stoi": True}},
    }


# ---------------------------------------------------------------------------
# FastEnhancer size table (reference: configs/fastenhancer/{t,s,b,m,l}.yaml)
# ---------------------------------------------------------------------------

# (channels, kernel_size, hop16k, rf_channels, rf_freq16k, num_blocks)
FE_SIZES: tp.Dict[str, tp.Tuple[int, list, int, int, int, int]] = {
    "t": (24, [8, 3, 3], 256, 20, 16, 2),
    "b": (48, [8, 3, 3], 256, 36, 24, 3),
    "s": (64, [8, 3, 3, 3], 256, 48, 36, 3),
    "m": (96, [8, 3, 3, 3], 160, 72, 48, 4),
    "l": (128, [8, 3, 3, 3, 3], 100, 96, 64, 5),
}
# 48 kHz deltas: n_fft 1024, hop doubled, RNNFormer freq widened
FE48_FREQ = {"t": 24, "b": 36, "s": 48, "m": 72, "l": 96}
FE48_HOP = {"t": 512, "b": 512, "s": 512, "m": 320, "l": 200}


def fe_model_kwargs(size: str, sr48: bool = False) -> Cfg:
    ch, ks, hop, rf_ch, freq, blocks = FE_SIZES[size]
    mk: Cfg = {
        "channels": ch,
        "kernel_size": list(ks),
        "stride": 4,
        "rnnformer_kwargs": {
            "num_blocks": blocks, "channels": rf_ch,
            "freq": FE48_FREQ[size] if sr48 else freq,
            "num_heads": 4, "eps": 1.0e-5, "positional_embedding": "train",
            "attn_bias": False, "post_act": False, "pre_norm": False,
        },
        "pre_post_init": "linear" if sr48 else "linear_fixed",
        "n_fft": 1024 if sr48 else 512,
        "hop_size": FE48_HOP[size] if sr48 else hop,
        "win_size": 1024 if sr48 else 512,
        "window": "hann",
        "stft_normalized": False,
        "mask": None,
        "activation": "SiLU",
        "activation_kwargs": {"inplace": True},
        "input_compression": 0.3,
        "normalize_final_conv": True,
        "weight_norm": True,
        "resnet": False,
    }
    if size == "l" and not sr48:
        mk["rnnformer_kwargs"]["p_dropout"] = 0.0
    return mk


def _fe_vbd(size: str) -> Cfg:
    return {
        "model": "fastenhancer.default",
        "model_kwargs": fe_model_kwargs(size),
        "wrapper": "ns",
        "data": DATA_VBD16,
        "train": train_section(LOSSES_VBD),
        **tail_sections(pesq_bs=8 if size == "l" else 16),
    }


def _fe_dns(size: str) -> Cfg:
    bs = 16 if size == "l" else 64
    return {
        "model": "fastenhancer.default",
        "model_kwargs": fe_model_kwargs(size),
        "wrapper": "ns_on_the_fly",
        "data": DATA_DNS16,
        "train": train_section(LOSSES_NO_PESQ, batch_size=bs, num_workers=8,
                               plot=False),
        **tail_sections(pesq_bs=4, executors=8,
                        valid_extra={"batch_size": bs, "num_workers": 2},
                        infer_extra={"num_workers": 0}),
    }


_48K_WORKERS = {"t": 24, "b": 16, "s": 16, "m": 8, "l": 4}


def _fe_48k(size: str) -> Cfg:
    bs = {"t": 64, "b": 64, "s": 64, "m": 32, "l": 16}[size]
    pesq_bs = {"t": 4, "b": 4, "s": 4, "m": 2, "l": 2}[size]
    execs = {"t": 8, "b": 8, "s": 8, "m": 4, "l": 4}[size]
    valid_nw = {"t": 2, "b": 2, "s": 2, "m": 2, "l": 1}[size]
    return {
        "model": "fastenhancer.default",
        "model_kwargs": fe_model_kwargs(size, sr48=True),
        "wrapper": "ns_on_the_fly",
        "data": DATA_48K,
        "train": train_section(LOSSES_NO_PESQ, batch_size=bs,
                               num_workers=_48K_WORKERS[size], plot=False),
        **tail_sections(pesq_bs=pesq_bs, executors=execs,
                        valid_extra={"batch_size": bs, "num_workers": valid_nw},
                        infer_extra={"num_workers": 0}),
    }


def _huge_noncausal(data: Cfg, sr: int) -> Cfg:
    """fastenhancer.noncausal 'huge' recipe (reference:
    configs/fastenhancer_dns/huge_noncausal.yaml)."""
    mk = fe_model_kwargs("l", sr48=(sr == 48000))
    mk["kernel_size"] = [8, 3, 3, 3, 3, 3]
    mk["rnnformer_kwargs"].update({"num_blocks": 6, "channels": 128,
                                   "freq": 64, "p_dropout": 0.0})
    mk["hop_size"] = {16000: 100, 24000: 100, 48000: 200}[sr]
    return {
        "model": "fastenhancer.noncausal",
        "model_kwargs": mk,
        "wrapper": "ns_on_the_fly",
        "data": data,
        "train": train_section(LOSSES_NO_PESQ, batch_size=16, num_workers=8,
                               plot=False),
        **tail_sections(pesq_bs=4, executors=8,
                        valid_extra={"batch_size": 16, "num_workers": 2},
                        infer_extra={"num_workers": 0}),
    }


# ---------------------------------------------------------------------------
# Ablations (reference: configs/ablation/*.yaml)
# ---------------------------------------------------------------------------

def _ablation_base(size: str) -> Cfg:
    cfg = _fe_vbd(size)
    cfg["model_kwargs"]["final_scale"] = True
    cfg["train"]["plot_param_and_grad"] = True
    cfg["train"]["optimizer_kwargs"].pop("projection", None)
    return cfg


def _dprnn(size: str) -> Cfg:
    cfg = _ablation_base(size)
    mk = cfg["model_kwargs"]
    rf = mk.pop("rnnformer_kwargs")
    mk.pop("resnet", None)
    mk["dprnn_kwargs"] = {
        "num_blocks": rf["num_blocks"], "channels": rf["channels"],
        "channels_frnn": rf["channels"] // 2, "freq": rf["freq"],
        "eps": 1.0e-5, "pre_norm": False,
    }
    cfg["model"] = "fastenhancer.dprnn"
    cfg["train"]["optimizer_groups"] = fe_optimizer_groups(
        prefix="dprnn", rnn_g=r"dprnn_block\.\d\.[tf]rnn", fc=r"[tf]rnn_fc")
    return cfg


def _dpt(size: str) -> Cfg:
    cfg = _ablation_base(size)
    mk = cfg["model_kwargs"]
    rf = mk.pop("rnnformer_kwargs")
    mk.pop("resnet", None)
    mk["final_scale_init"] = "one"
    mk["dpt_kwargs"] = {
        "num_blocks": rf["num_blocks"], "channels": rf["channels"],
        "freq": rf["freq"], "num_heads": 4, "eps": 1.0e-5, "lookbehind": 31,
        "positional_embedding": "train", "attn_bias": False,
        "post_act": False, "pre_norm": False,
    }
    cfg["model"] = "fastenhancer.dptransformer"
    cfg["train"]["optimizer_groups"] = fe_optimizer_groups(
        prefix="dpt", rnn_g=r"NOMATCH", fc=r"(time|freq)_fc")
    # dpt has no GRU g-group; first group keeps only dec_post scale
    cfg["train"]["optimizer_groups"][0]["regex_list"] = [r"dec_post\.3\.scale"]
    return cfg


def _ln(size: str) -> Cfg:
    cfg = _ablation_base(size)
    cfg["model"] = "fastenhancer.ln"
    cfg["model_kwargs"]["final_scale_init"] = "one"
    # no BN -> pre-BN conv weights move to the layerwise group
    cfg["train"]["optimizer_groups"] = [
        {"regex_list": [r"rf_block\.\d\.rnn\.parametrizations.+original0$",
                        r"dec_post\.3\.scale"],
         "weight_decay": 0, "projection": "disabled"},
        {"regex_list": [r".+parametrizations.+original1$"],
         "projection": "channelwise"},
        {"regex_list": [r"rf_(pre|post)\.0\.weight", r"enc_pre\.0\.weight",
                        r"encoder\.\d\.0\.weight", r"rf_(pre|post)\.1\.weight",
                        r"(rnn|attn)_fc\.weight", r"decoder\.\d\.[03]\.weight",
                        r"dec_post\.0\.weight", r"dec_post\.3\.weight"],
         "projection": "layerwise"},
    ]
    return cfg


def _time_kernel(size: str) -> Cfg:
    cfg = _ablation_base(size)
    mk = cfg["model_kwargs"]
    ks = mk.pop("kernel_size")
    mk.pop("resnet", None)
    mk["kernel_size_freq"] = ks
    mk["kernel_size_time"] = 3
    cfg["model"] = "fastenhancer.time_kernel"
    return cfg


# ---------------------------------------------------------------------------
# Baselines (reference: configs/others/*.yaml)
# ---------------------------------------------------------------------------

_STFT16 = {"n_fft": 512, "hop_size": 256, "win_size": 512,
           "input_compression": 0.3}


def _bsrnn(num_channels: int, num_layers: int) -> Cfg:
    return {
        "model": "bsrnn",
        "model_kwargs": {"num_channels": num_channels,
                         "num_layers": num_layers, "bias": True,
                         "affine": True, **_STFT16, "window": "hann"},
        "wrapper": "ns",
        "data": DATA_VBD16,
        "train": train_section(LOSSES_VBD, optimizer="AdamW",
                               optimizer_groups=None, fp16=False, plot=True),
        **tail_sections(),
    }


def _fspen() -> Cfg:
    return {
        "model": "fspen",
        "model_kwargs": {
            "channels": [4, 16, 32], "kernel_size": [6, 8, 6],
            "stride": [2, 2, 2],
            "dpe_kwargs": {"num_blocks": 3, "channels": 16, "freq": 32,
                           "groups": 8, "norm": "LayerNorm-FreqChannels"},
            **_STFT16, "window": "hann",
        },
        "wrapper": "ns",
        "data": DATA_VBD16,
        "train": train_section(
            LOSSES_VBD, fp16=False, plot=True,
            optimizer_groups=[
                {"regex_list": [r"fullband_encoder\.\d\.0\.weight"],
                 "projection": "channelwise"},
                {"regex_list": [r"fullband_decoder\.[01]\.1\.weight"],
                 "projection": 1},
            ]),
        **tail_sections(),
    }


def _lisennet() -> Cfg:
    return {
        "model": "lisennet",
        "model_kwargs": {"num_channels": 16, "n_blocks": 2, **_STFT16},
        "wrapper": "ns",
        "data": DATA_VBD16,
        "train": train_section(
            LOSSES_VBD, optimizer="AdamW", fp16=False, plot=True,
            optimizer_groups=[
                {"regex_list": [r"encoder\.conv_1\.2\.weight",
                                r"encoder\.conv_\d\.act\.weight",
                                r"decoder\.mask_conv\.3\.weight",
                                r"decoder\.lsigmoid.slope"],
                 "weight_decay": 0},
            ]),
        **tail_sections(),
    }


def _dns_variant(cfg: Cfg, pesq_bs: int = 16, executors: int = 16) -> Cfg:
    """Move a VBD recipe onto the DNS on-the-fly pipeline
    (reference: configs/others_dns/*.yaml)."""
    cfg = copy.deepcopy(cfg)
    cfg["wrapper"] = "ns_on_the_fly"
    cfg["data"] = DATA_DNS16
    cfg["train"]["num_workers"] = 8
    cfg["train"]["plot_param_and_grad"] = False
    cfg["train"]["losses"].pop("pesq", None)
    cfg["valid"]["num_workers"] = 2
    cfg["pesq"]["batch_size"] = pesq_bs
    cfg["pesq"]["num_workers_executor"] = executors
    return cfg


# ---------------------------------------------------------------------------
# Build everything
# ---------------------------------------------------------------------------

def _shard_cfg(train_dataset: str) -> Cfg:
    """Lhotse-shar pipeline recipe, key-for-key with the reference
    (reference: configs/fastenhancer_shard/t.yaml). Only deviation: shard
    dirs are rooted at data/shards/ (the reference used absolute home
    paths); the source basenames are kept. Note the reference's
    optimizer_groups here use regexes from an older model naming scheme
    (`rnn.\\d.rnn`, `rnn_pre`, ...) that match no fastenhancer.default
    parameter — every param lands in the default AdamP group ("auto"
    projection). Replicated verbatim for behavior parity.
    pin_memory/prefetch_factor are torch-DataLoader knobs our host loader
    ignores; carried so the recipes stay key-identical."""
    cfg = _fe_dns("t")
    cfg["wrapper"] = "ns_shard"
    cfg["data"] = deep_merge(DATA_DNS16, {})
    cfg["data"]["dataset"] = {"train": train_dataset,
                              "valid": "NoiseSuppression",
                              "infer": "NoiseSuppression",
                              "pesq": "NoiseSuppression"}
    for k in ("reverb_prob", "silence_length", "snr_mixer"):
        cfg["data"].pop(k, None)
    cfg["data"]["max_duration"] = 128
    cfg["data"]["dereverberation"] = {"rir_target_type": "rts",
                                      "early_rir_sec": 0.05, "t60_max": 0.15}
    shard_root = "data/shards"

    def sources(kind: str, *pairs: tp.Tuple[str, float]) -> list:
        return [{"shard_dir": f"{shard_root}/{kind}/{name}", "weight": w}
                for name, w in pairs]

    cfg["data"]["train"] = {
        "inputs": {
            "speech": sources(
                "speech", ("dns-wo-german-w-singing", 2.0),
                ("vctk-train", 2.0), ("aishell3", 2.0), ("ears", 1.0),
                ("hifitts1-clean", 1.0), ("expresso", 1.0)),
            "noise": sources(
                "noise", ("dns", 4.0), ("demand-train", 2.0), ("wham", 2.0),
                ("tut-urban-2018-dev", 2.0), ("fma", 2.0)),
            "rir": sources("rir", ("dns-rir", 1.0)),
        },
        "mixer": {"speech_dbFS": [-35.0, -15.0], "snr": [0.0, 20.0],
                  "seg_rel_threshold": -25.0, "seg_abs_threshold": None},
        "num_buckets": 30,
        "max_utt_duration": 20.0,
        "min_utt_duration": 0.5,
        "prob_speech_codec": 0.0,
        "prob_speech_reverb": 0.5,
        "prob_farend_echo": 0.0,
        "prob_farend_only": 0.0,
        "prob_noise": 1.0,
        "aux_buffer_size": 5000,
        "sampler_buffer_size": 10000,
        "shuffle": True,
        "num_workers": 2,
        "pin_memory": False,
        "persistent_workers": True,
        "prefetch_factor": 1,
    }
    # reference train section: no batch_size (duration bucketing), intervals
    # of 10, the stale optimizer_groups, and no explicit AdamP projection
    cfg["train"] = {
        "test": False,
        "save_interval": 10,
        "max_epochs": 200,
        "steps_per_epoch": 1000,
        "fp16": True,
        "clip_grad": None,
        "seed": 1,
        "plot_param_and_grad": False,
        "losses": copy.deepcopy(LOSSES_NO_PESQ),
        "optimizer": "AdamP",
        "optimizer_kwargs": {"lr": 2.0e-3, "weight_decay": 0.01,
                             "wd_ratio": 1.0, "betas": [0.95, 0.999]},
        "optimizer_groups": [
            {"regex_list": [r"rnn\.\d\.rnn.+parametrizations.+original0$",
                            r"enc_pre\.2\.weight",
                            r"(en|de)coder\.\d\.2\.weight",
                            r"rnn_(pre|post)\.1\.weight",
                            r"dec_post\.scale"],
             "weight_decay": 0, "projection": "disabled"},
            {"regex_list": [r"rnn_pre\.0.+parametrizations.+original1$",
                            r"rnn\.\d\..+parametrizations.+original1$",
                            r"enc_pre\.0\.weight",
                            r"(en|de)coder\.\d\.0\.weight",
                            r"rnn_(pre|post)\.2\.weight"],
             "projection": "channelwise"},
            {"regex_list": [r"dec_post\.weight"], "projection": "layerwise"},
            {"regex_list": [r"rnn_post\.0.+parametrizations.+original1$"],
             "projection": 1},
        ],
        "scheduler": "CosineAnnealingWarmup",
        "scheduler_kwargs": {"warmup_iterations": 500, "eta_min": 1.0e-6,
                             "warn": False},
    }
    cfg["valid"] = {"batch_size": 64, "num_workers": 2}
    cfg["infer"] = {"batch_size": 1, "interval": 10, "num_workers": 0}
    cfg["pesq"] = {"batch_size": 4, "num_workers": 0,
                   "num_workers_executor": 8, "interval": 10,
                   "metrics_to_calculate": {"pesq": True, "stoi": True}}
    return cfg


def build_all() -> tp.Dict[str, Cfg]:
    """relative path (without .yaml) -> config dict."""
    out: tp.Dict[str, Cfg] = {}
    for s in FE_SIZES:
        out[f"fastenhancer/{s}"] = _fe_vbd(s)
        out[f"fastenhancer_dns/{s}"] = _fe_dns(s)
        out[f"fastenhancer_48khz/{s}"] = _fe_48k(s)
    out["fastenhancer_dns/huge_noncausal"] = _huge_noncausal(DATA_DNS16, 16000)

    hn24 = _huge_noncausal(copy.deepcopy(DATA_DNS16), 24000)
    hn24["data"]["sampling_rate"] = 24000
    hn24["data"]["train"].update({"clean_dir": f"{_DNS24}/clean",
                                  "noise_dir": f"{_DNS24}/noise",
                                  "segment_size": 48000})
    for sec in ("valid", "infer", "pesq"):
        hn24["data"][sec].update({
            "clean_dir": f"{_VBD24}/clean_testset_wav",
            "noisy_dir": f"{_VBD24}/noisy_testset_wav"})
        if sec != "infer":
            hn24["data"][sec]["metadata"] = f"{_VBDLOG}/log_testset.txt"
    hn24["data"]["infer"]["files"] = ["p232_013", "p257_090", "p232_010",
                                      "p257_042"]
    hn24["data"]["valid"]["segment_size"] = 48000
    out["fastenhancer_dns/huge_noncausal_24khz"] = hn24

    hn48 = _huge_noncausal(DATA_48K, 48000)
    out["fastenhancer_48khz/huge_noncausal"] = hn48

    for s in FE_SIZES:
        out[f"ablation/dprnn_{s}"] = _dprnn(s)
    for s in ("t", "s", "b", "m"):
        out[f"ablation/dpt_{s}"] = _dpt(s)
    out["ablation/ln_b"] = _ln("b")
    out["ablation/time_kernel_b"] = _time_kernel("b")

    out["others/bsrnn_t"] = _bsrnn(32, 6)
    out["others/bsrnn_s"] = _bsrnn(64, 6)
    out["others/bsrnn_xt"] = _bsrnn(16, 6)
    out["others/bsrnn_xxt"] = _bsrnn(16, 2)
    out["others/fspen"] = _fspen()
    out["others/lisennet"] = _lisennet()

    out["fastenhancer_shard/t"] = _shard_cfg("ShardOnTheFly")
    out["fastenhancer_shard/t_segment"] = _shard_cfg("ShardSegment")

    out["others_dns/bsrnn_xt"] = _dns_variant(_bsrnn(16, 6))
    out["others_dns/fspen"] = _dns_variant(_fspen())
    out["others_dns/lisennet"] = _dns_variant(_lisennet(), pesq_bs=4,
                                              executors=8)
    tk = _dns_variant(_time_kernel("b"), pesq_bs=16)
    tk["pesq"]["num_workers_executor"] = 16
    tk["train"]["fp16"] = True
    out["others_dns/fastenhancer_time_kernel_b"] = tk
    return out
