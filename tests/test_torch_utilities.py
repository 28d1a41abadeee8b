"""The port's small utilities against the JAX package's: `get_mask`,
`stream_stft` / `stream_istft`, and the clean_checkpoint and resample
scripts (fastenhancer_tpu_torch/scripts/) against scripts/*.py."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastenhancer_tpu import functional as jF
from fastenhancer_tpu_torch import functional as tF
from fastenhancer_tpu_torch.data.audio_io import read_wav, write_wav
from fastenhancer_tpu_torch.scripts import clean_checkpoint, resample

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")



def test_get_mask_equals_jax():
    length = np.array([0, 3, 7, 12, 5], np.int32)
    want = np.asarray(jF.get_mask(jnp.asarray(length), 9))
    got = tF.get_mask(torch.from_numpy(length), 9)
    assert got.dtype == torch.bool and got.shape == (5, 1, 9)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_fft,hop,method", [(512, 256, "fft"),
                                              (128, 64, "matmul"),
                                              (400, 100, "fft")])
def test_stream_stft_and_istft_equal_jax(n_fft, hop, method):
    rng = np.random.default_rng(n_fft)
    wav = rng.standard_normal((3, hop * 11)).astype(np.float32) * 0.3
    jcfg = jF.STFTConfig(n_fft=n_fft, hop_size=hop, method=method)
    tcfg = tF.STFTConfig(n_fft=n_fft, hop_size=hop, method=method)
    want = np.asarray(jF.stream_stft(jnp.asarray(wav), jcfg))
    got = tF.stream_stft(torch.from_numpy(wav), tcfg)
    assert got.shape == want.shape == (3, n_fft // 2 + 1, 11, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(
        1.0, np.abs(want).max())
    want_y = np.asarray(jF.stream_istft(jnp.asarray(want), jcfg))
    got_y = tF.stream_istft(torch.from_numpy(want.copy()), tcfg)
    assert got_y.shape == want_y.shape == wav.shape
    assert np.abs(got_y.numpy() - want_y).max() <= 1e-6


def _run_dirs(root):
    for run in ("a", "b/c"):
        d = root / run
        d.mkdir(parents=True)
        for e in (1, 2, 3, 10):
            (d / f"{e:05d}.ckpt").write_bytes(b"x")
        (d / "config.yaml").write_text("k: 1\n")


@pytest.mark.parametrize("keep", [1, 2, 0])
def test_clean_checkpoint_equals_jax_script(tmp_path, capsys, monkeypatch,
                                            keep):
    from scripts import clean_checkpoint as jax_clean

    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _run_dirs(jax_root)
    _run_dirs(port_root)
    monkeypatch.setattr(sys, "argv", ["clean_checkpoint", str(jax_root),
                                      "--keep", str(keep)])
    jax_clean.main()
    want = capsys.readouterr().out
    clean_checkpoint.main([str(port_root), "--keep", str(keep)])
    out = capsys.readouterr().out
    assert out == want.replace(str(jax_root), str(port_root))
    for run in ("a", "b/c"):
        kept = sorted(os.listdir(port_root / run))
        assert kept == sorted(os.listdir(jax_root / run))
        assert kept == (["00003.ckpt", "00010.ckpt"][-keep:] if keep
                        else []) + ["config.yaml"]


def test_clean_checkpoint_dry_run_removes_nothing(tmp_path, capsys):
    _run_dirs(tmp_path)
    clean_checkpoint.main([str(tmp_path), "--dry-run"])
    assert "remove 3" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "a")) == 5


class _InProcess:
    """ProcessPoolExecutor's part that the resample scripts use, run in
    this process: a fork of it, holding JAX's and torch's threads, is
    what the scripts' pool would make."""

    def __init__(self, jobs, mp_context=None):
        assert jobs >= 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return map(fn, jobs)


def test_resample_equals_jax_script(tmp_path, monkeypatch, capsys):
    """Two wavs (one past full scale after the polyphase filter, one
    quiet) at 48 kHz resampled to 16 kHz by both scripts' main: the same
    files, sample for sample, and the same lines."""
    from scripts import resample as jax_resample

    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    t = np.arange(4800) / 48000
    loud = np.sign(np.sin(2 * np.pi * 440 * t)) * 0.9999  # overshoots
    quiet = np.random.default_rng(0).standard_normal(4800) * 0.05
    write_wav(str(src / "loud.wav"), loud, 48000)
    write_wav(str(src / "sub" / "quiet.WAV"), quiet, 48000)
    monkeypatch.setattr(jax_resample, "ProcessPoolExecutor", _InProcess)
    monkeypatch.setattr(resample, "ProcessPoolExecutor", _InProcess)
    monkeypatch.setattr(sys, "argv", [
        "resample", "-i", str(src), "-o", str(tmp_path / "jax"), "--sr",
        "16000", "-j", "1"])
    jax_resample.main()
    want = capsys.readouterr().out
    resample.main(["-i", str(src), "-o", str(tmp_path / "port"), "--sr",
                   "16000", "-j", "1"])
    assert capsys.readouterr().out == want
    assert "resampled 2 files to 16000 Hz" in want
    for rel in ("loud.wav", "sub/quiet.WAV"):
        want = (tmp_path / "jax" / rel).read_bytes()
        assert (tmp_path / "port" / rel).read_bytes() == want, rel
        x, sr = read_wav(str(tmp_path / "port" / rel))
        assert sr == 16000 and len(x) == 1600
    peak = np.abs(read_wav(str(tmp_path / "port" / "loud.wav"))[0]).max()
    assert peak <= 0.999 + 1 / 32768
