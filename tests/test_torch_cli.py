"""The training entry point (`python -m fastenhancer_tpu_torch.train`) on
the CPU: the shard recipe's config with a tiny model, synthetic shards and
paired wavs, two epochs of two steps with PESQ/STOI and a checkpoint each,
then a resume that runs a third. Spies count #4's and #5's plain versions
on the path: the mixer's segmental RMS twice a train step, the GRU scan
once a block in every valid and every PESQ forward."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.ops import segmental_rms as seg
from fastenhancer_tpu_torch.train.__main__ import main
from fastenhancer_tpu_torch.utils.hparams import get_hparams

from _torch_parity import (TINY_KWARGS, one_thread_env,
                           real_triton_only, torch_one_thread,  # noqa: F401
                           write_shard_dir, write_wav_pairs)

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fastenhancer_shard", "t.yaml")


def _overrides(root):
    speech = write_shard_dir(root, "speech", seed=1, dur=(1.0, 2.0))
    noise = write_shard_dir(root, "noise", seed=2, dur=(1.0, 2.0),
                            silent_first=True)
    rir = write_shard_dir(root, "rir", seed=3, n_shards=1, dur=(0.5, 0.5),
                          custom={"rir_onset": 10, "t60": 0.3})
    clean, noisy = write_wav_pairs(root / "wav", seed=4, n=5,
                                   dur=(1.0, 2.0))
    inputs = {"speech": [{"shard_dir": speech}],
              "noise": [{"shard_dir": noise}], "rir": [{"shard_dir": rir}]}
    return [f"model_kwargs={TINY_KWARGS!r}",
            f"data.train.inputs={inputs!r}", "data.train.num_workers=1",
            "data.max_duration=6", f"data.valid.clean_dir={clean}",
            f"data.valid.noisy_dir={noisy}", f"data.pesq.clean_dir={clean}",
            f"data.pesq.noisy_dir={noisy}", "train.steps_per_epoch=2",
            "train.max_epochs=2", "train.save_interval=1", "pesq.interval=1",
            "valid.batch_size=2", "valid.num_workers=1", "pesq.batch_size=2"]


def test_cli_trains_validates_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                      capsys):
    calls = {"rms": 0, "scan": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(seg, "segmental_rms", spy("rms", seg.segmental_rms))
    monkeypatch.setattr(scan, "gru_scan_reference",
                        spy("scan", scan.gru_scan_reference))
    params = _overrides(tmp_path)
    logs = str(tmp_path / "logs")
    history = main(["-n", "run", "-c", CONFIG, "--base_dir", logs,
                    "--device", "cpu", "-p", *params])
    run = os.path.join(logs, "run")
    assert sorted(os.listdir(run)) == ["00001.ckpt", "00002.ckpt",
                                       "config.yaml", "train", "valid"]
    hps = get_hparams(None, run)
    assert hps.train.steps_per_epoch == 2 and hps.model_kwargs.channels == 12
    assert [r["epoch"] for r in history] == [1, 2]
    blocks = TINY_KWARGS["rnnformer_kwargs"]["num_blocks"]
    # 5 files in batches of 2: 3 valid batches and 3 PESQ batches an epoch
    assert calls == {"rms": 2 * 2 * 2, "scan": 2 * blocks * (3 + 3)}
    for r in history:
        assert all(np.isfinite(v) for v in r["train"].values())
        assert all(np.isfinite(v) for v in r["valid"].values())
        assert 1.0 <= r["valid"]["metrics/pesq"] <= 4.65
        assert 0.0 <= r["valid"]["metrics/stoi"] <= 1.0
        assert r["timing"].keys() == {"load", "step", "steps", "valid",
                                      "metrics", "summarize"}
    out = capsys.readouterr().out
    assert "rank 0 of 1, device: cpu" in out and "Epoch 2/2  valid:" in out
    assert "best PESQ" in out

    # resume: no -c; the run dir's config with max_epochs raised
    calls.update(rms=0, scan=0)
    history = main(["-n", "run", "--base_dir", logs, "--device", "cpu",
                    "-p", "train.max_epochs=3", "-f"])
    out = capsys.readouterr().out
    assert "loaded checkpoint" in out and "00002.ckpt (epoch 2)" in out
    assert [r["epoch"] for r in history] == [3]
    assert os.path.exists(os.path.join(run, "00003.ckpt"))
    assert calls == {"rms": 2 * 2, "scan": blocks * (3 + 3)}
    assert get_hparams(None, run).train.max_epochs == 3


def test_cli_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-n", "run", "-c", CONFIG, "--base_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "fastenhancer_tpu_torch.train", "-n", "run",
         "-c", CONFIG, "--base_dir", str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=one_thread_env(PYTHONPATH=REPO))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "fastenhancer_tpu_torch.train", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=one_thread_env(PYTHONPATH=REPO))
    assert proc.returncode == 0
    assert all(f in proc.stdout for f in ("--name", "--config", "--params",
                                          "--force_save", "--base_dir",
                                          "--device"))
