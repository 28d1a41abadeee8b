"""The training entry point (`python -m fastenhancer_tpu_torch.train`) on
each of the eight VoiceBank recipes on the CPU (FE-B, the dpt, dprnn, ln
and time_kernel ablations, BSRNN-S, FSPEN, LiSenNet): the recipe's config
with tiny model_kwargs, paired wavs, one epoch of two steps with the
recipe's losses (`pesq` among them), valid and PESQ/STOI and a checkpoint;
a spy counts #5's plain version, which runs only in the valid and PESQ
forwards. Apart from tests/test_torch_cli.py so that xdist can run the two
files on two workers."""
import os

import numpy as np
import pytest

from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.train.__main__ import main

from _torch_parity import (TINY_KWARGS, real_triton_only,  # noqa: F401
                           torch_one_thread,  # noqa: F401
                           write_wav_pairs)

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the VoiceBank recipes (data.train/valid/pesq paired wavs) at tiny widths:
# config -> (model_kwargs, #5 launches per offline forward)
_FE = dict(channels=12, stride=4, n_fft=128, hop_size=64, win_size=128,
           window="hann", weight_norm=True, pre_post_init="linear_fixed",
           normalize_final_conv=True, activation="SiLU")
_BLOCKS = dict(num_blocks=2, channels=8, freq=8)
_STFT = dict(n_fft=512, hop_size=256, win_size=512, window="hann")
VOICEBANK = {
    "fastenhancer/b.yaml": (dict(
        _FE, kernel_size=[4, 3],
        rnnformer_kwargs=dict(_BLOCKS, num_heads=2)), 2),
    "ablation/dpt_b.yaml": (dict(
        _FE, kernel_size=[4, 3],
        dpt_kwargs=dict(_BLOCKS, num_heads=2, lookbehind=5)), 0),
    "ablation/dprnn_b.yaml": (dict(
        _FE, kernel_size=[4, 3],
        dprnn_kwargs=dict(_BLOCKS, channels_frnn=4)), 2),
    "ablation/ln_b.yaml": (dict(TINY_KWARGS), 2),
    "ablation/time_kernel_b.yaml": (dict(
        _FE, kernel_size_freq=[4, 3], kernel_size_time=3,
        rnnformer_kwargs=dict(_BLOCKS, num_heads=2)), 2),
    "others/bsrnn_s.yaml": (dict(_STFT, num_channels=8, num_layers=1), 0),
    "others/fspen.yaml": (dict(_STFT, channels=[4, 8, 16], dpe_kwargs=dict(
        num_blocks=1, channels=8, groups=2)), 1 * (2 + 2)),
    "others/lisennet.yaml": (dict(_STFT, num_channels=8, n_blocks=1), 3),
}


@pytest.mark.parametrize("config", list(VOICEBANK))
def test_cli_trains_a_voicebank_recipe(config, tmp_path, monkeypatch):
    """`main` on the recipe's config with tiny model_kwargs, paired wavs
    for train, valid and PESQ: 1 epoch of 2 steps (4 files in batches of
    2) with the recipe's losses, `pesq` among them, valid and PESQ/STOI in
    batches of 2, a checkpoint. #5's plain version runs only in the valid
    and PESQ forwards: per forward as the family's GRUs need it, never in a
    train step."""
    model_kwargs, per_forward = VOICEBANK[config]
    calls = {"scan": 0}
    real = scan.gru_scan_reference

    def spy(*args, **kwargs):
        calls["scan"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(scan, "gru_scan_reference", spy)
    train = write_wav_pairs(tmp_path / "train", seed=5, n=4, dur=(0.6, 0.8))
    clean, noisy = write_wav_pairs(tmp_path / "wav", seed=6, n=3,
                                   dur=(0.6, 1.0))
    logs = str(tmp_path / "logs")
    history = main([
        "-n", "run", "-c", os.path.join(REPO, "configs", config),
        "--base_dir", logs, "--device", "cpu", "-p",
        f"model_kwargs={model_kwargs!r}", f"data.train.clean_dir={train[0]}",
        f"data.train.noisy_dir={train[1]}", "data.train.segment_size=8192",
        f"data.valid.clean_dir={clean}", f"data.valid.noisy_dir={noisy}",
        "data.valid.segment_size=8192", f"data.pesq.clean_dir={clean}",
        f"data.pesq.noisy_dir={noisy}", "train.batch_size=2",
        "train.num_workers=1", "train.max_epochs=1", "train.save_interval=1",
        "valid.batch_size=2", "pesq.batch_size=2",
        "pesq.interval=1", "train.fp16=False"])
    run = os.path.join(logs, "run")
    assert sorted(os.listdir(run)) == ["00001.ckpt", "config.yaml", "train",
                                       "valid"]
    (r,) = history
    assert "loss/pesq" in r["train"] and "loss/pesq" in r["valid"]
    assert all(np.isfinite(v) for v in r["train"].values())
    assert all(np.isfinite(v) for v in r["valid"].values())
    assert 1.0 <= r["valid"]["metrics/pesq"] <= 4.65
    assert r["timing"]["steps"] == 2
    # 3 valid files in batches of 2, 3 PESQ files in batches of 2
    assert calls["scan"] == per_forward * (2 + 2)
