"""The port's host data layer against the JAX package's: WAV IO, the
paired-wav dataset with the threaded loader, and the shard reader.

Both packages read the same synthetic files (tests/_torch_parity.py writes
them from a seed); batches must be equal bit for bit. The shard reader runs
one producer thread: with more, batches interleave in timing order.
"""
import os
import random
import struct

import numpy as np
import pytest

from fastenhancer_tpu.data import get_dataset_dataloader as jget_loader
from fastenhancer_tpu.data import audio_io as jaudio
from fastenhancer_tpu.data.shard import ShardDataset as JShardDataset
from fastenhancer_tpu.utils.hparams import HParams as JHParams
from fastenhancer_tpu_torch.data import audio_io, get_dataset_dataloader
from fastenhancer_tpu_torch.data.loader import DataLoader
from fastenhancer_tpu_torch.data.noise_suppression import NSDataset
from fastenhancer_tpu_torch.data.shard import ShardDataset
from fastenhancer_tpu_torch.utils.hparams import HParams

from _torch_parity import (SR, write_shard_dir, write_wav_pairs,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _float_wav(path, x, channels=1):
    """An IEEE-float (format 3) WAV file."""
    data = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, channels, SR, SR * 4 * channels,
                      4 * channels, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
                + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(data)) + data)


def test_wav_round_trip_and_reads_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(SR) * 0.2).astype(np.float32)
    stereo = (rng.standard_normal((SR // 2, 2)) * 0.2).astype(np.float32)
    mono_path, st_path, f_path = (str(tmp_path / n) for n in
                                  ("m.wav", "s.wav", "f.wav"))
    audio_io.write_wav(mono_path, x, SR)
    audio_io.write_wav(st_path, stereo, SR)
    _float_wav(f_path, x)
    y, sr = audio_io.read_wav(mono_path)
    assert sr == SR and y.dtype == np.float32
    assert np.abs(y - x).max() <= 1.0 / 32768
    for path in (mono_path, st_path, f_path):
        for kw in ({}, {"mono": False}, {"offset": 0.1, "duration": 0.2},
                   {"offset": 0.25}, {"sr": 8000}):
            got, sr_got = audio_io.read_wav(path, **kw)
            want, sr_want = jaudio.read_wav(path, **kw)
            assert sr_got == sr_want and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {kw}")
        assert audio_io.wav_info(path) == jaudio.wav_info(path)
        if path != f_path:  # the stdlib `wave` reads PCM only
            assert audio_io.wav_duration(path) == jaudio.wav_duration(path)
        got, _ = audio_io.read_audio(path, offset=0.05, duration=0.1)
        want, _ = jaudio.read_audio(path, offset=0.05, duration=0.1)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio_io.resample(x, SR, 24000),
                                  jaudio.resample(x, SR, 24000))
    with pytest.raises(ValueError, match="RIFF"):
        (tmp_path / "bad.wav").write_bytes(b"not a wav file at all")
        audio_io.read_wav(str(tmp_path / "bad.wav"))


def _ns_config(clean, noisy, hop=64):
    sec = {"clean_dir": clean, "noisy_dir": noisy}
    return {
        "data": {"dataset": "NoiseSuppression", "sampling_rate": SR,
                 "valid": dict(sec, segment_size=8000),
                 "pesq": dict(sec, segment_size=None)},
        "model_kwargs": {"hop_size": hop},
        "train": {"batch_size": 2, "num_workers": 1},
        "valid": {"batch_size": 2, "num_workers": 1},
        "pesq": {"batch_size": 2, "num_workers": 1},
    }


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("mode,keys", [
    ("valid", ["clean", "noisy"]),
    ("pesq", ["clean", "noisy", "wav_len"])])
def test_ns_dataset_and_loader_match_jax(tmp_path, mode, keys):
    """Random crops and centre padding (valid, 0.5 s segments of 0.3-1 s
    files) and length-sorted, 16-hop padded batches with wav_len (pesq),
    each before and after shuffle(seed)."""
    clean, noisy = write_wav_pairs(tmp_path, seed=1, n=7, dur=(0.3, 1.0))
    cfg = _ns_config(clean, noisy)
    port_ds, port = get_dataset_dataloader(HParams(**cfg), mode, keys)
    jax_ds, jax_loader = jget_loader(JHParams(**cfg), mode, keys)
    assert isinstance(port_ds, NSDataset) and len(port) == len(jax_loader)
    for shuffle in (None, 5):
        if shuffle is not None:
            port_ds.shuffle(shuffle)
            jax_ds.shuffle(shuffle)
            assert port_ds.files == jax_ds.files
        random.seed(11)
        got = list(port)
        random.seed(11)
        want = list(jax_loader)
        _assert_batches_equal(got, want)
        if mode == "pesq" and shuffle is None:  # sorted by duration
            lens = np.concatenate([b["wav_len"] for b in got]).tolist()
            assert lens == sorted(lens)
    assert len(got) == 4 and got[-1]["clean"].shape[0] == 1
    if mode == "pesq":
        assert all(b["clean"].shape[-1] % (16 * 64) == 0 for b in got)
    else:
        assert all(b["clean"].shape == (b["clean"].shape[0], 8000)
                   for b in got)


def test_loader_passes_a_worker_error_on(tmp_path):
    clean, noisy = write_wav_pairs(tmp_path, seed=2, n=4)
    with open(os.path.join(noisy, "002.wav"), "wb") as f:
        f.write(b"broken")
    cfg = _ns_config(clean, noisy)
    _, loader = get_dataset_dataloader(HParams(**cfg), "valid",
                                       ["clean", "noisy"])
    it = iter(loader)
    next(it)  # files 000 and 001
    with pytest.raises(ValueError, match="RIFF"):
        next(it)


def test_loader_drop_last_and_collate():
    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"x": np.full(i + 1, i, np.float32), "x_len": i + 1,
                    "filename": f"f{i}"}

    batches = list(DataLoader(Items(), batch_size=2, num_workers=2,
                              drop_last=True, pad_multiple=4))
    assert len(batches) == 2
    assert batches[1]["x"].shape == (2, 4)
    np.testing.assert_array_equal(batches[1]["x_len"], [3, 4])
    assert batches[1]["filename"] == ["f2", "f3"]


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    return {
        "speech": write_shard_dir(root, "speech", seed=1, dur=(0.6, 2.0)),
        "speech2": write_shard_dir(root, "speech2", seed=2, cuts=3),
        "noise": write_shard_dir(root, "noise", seed=3, dur=(0.3, 1.0),
                                 silent_first=True),
        "rir": write_shard_dir(root, "rir", seed=4, n_shards=1,
                               dur=(0.1, 0.3),
                               custom={"rir_onset": 10, "t60": 0.4}),
    }


def _shard_config(dirs, segment):
    train = {
        "inputs": {
            "speech": [{"shard_dir": dirs["speech"], "weight": 2.0},
                       {"shard_dir": dirs["speech2"], "weight": 1.0}],
            "noise": [{"shard_dir": dirs["noise"], "weight": 1.0}],
            "rir": [{"shard_dir": dirs["rir"], "weight": 1.0}],
        },
        "num_buckets": 5, "max_utt_duration": 20.0, "min_utt_duration": 0.1,
        "prob_speech_reverb": 0.5, "prob_noise": 0.9, "aux_buffer_size": 6,
        "num_workers": 1,
    }
    if segment:
        train["segment_size"] = SR
    return {"data": {"dataset": {"train": "ShardSegment" if segment
                                 else "ShardOnTheFly"},
                     "sampling_rate": SR, "max_duration": 4.0,
                     "train": train}}


FIELDS = ("speech", "speech_clean", "noise", "rir", "rir_onset", "rir_t60",
          "num_samples", "id_speech", "farend", "echo", "is_real", "text")


@pytest.mark.parametrize("segment", [False, True])
def test_shard_dataset_matches_jax(shard_dirs, segment):
    """Two epochs (shuffle(seed + epoch), release_auxiliary between them)
    through get_dataset_dataloader: every ShardBatch field equal."""
    cfg = _shard_config(shard_dirs, segment)
    port_ds, port = get_dataset_dataloader(HParams(**cfg), "train",
                                           ["speech", "speech_clean",
                                            "noise"])
    jax_ds, jax_loader = jget_loader(JHParams(**cfg), "train",
                                     ["speech", "speech_clean", "noise"])
    assert isinstance(port_ds, ShardDataset) and port is port_ds
    assert isinstance(jax_ds, JShardDataset)
    for epoch in (1, 2):
        port_ds.shuffle(7 + epoch)
        jax_ds.shuffle(7 + epoch)
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            for f in FIELDS:
                a, b = getattr(g, f), getattr(w, f)
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=f)
                    assert a.dtype == b.dtype, f
                else:
                    assert a == b, f
        port_ds.release_auxiliary()
        jax_ds.release_auxiliary()
    assert all((np.abs(b.speech[:, 0]).max(axis=1) > 0).all() for b in got)
    if segment:
        assert all(b.speech.shape[-1] == SR for b in got)
    else:
        assert sum(b.speech.shape[0] for b in got) == 14  # every cut once
    # rows without noise (prob_noise, the silent cut) and reverberant rows
    assert any((np.abs(b.noise[:, 0]).max(axis=1) == 0).any() for b in got)
    assert any((b.rir_onset == 10).any() for b in got)


def test_shard_dataset_passes_a_reader_error_on(tmp_path):
    speech = write_shard_dir(tmp_path, "speech", seed=5, n_shards=1)
    tar = os.path.join(speech, "recording.000000.tar")
    with open(tar, "r+b") as f:  # the first member's RIFF tag
        f.seek(512)
        f.write(b"JUNK")
    cfg = {"data": {"dataset": "ShardOnTheFly", "sampling_rate": SR,
                    "max_duration": 4.0,
                    "train": {"inputs": {"speech": [{"shard_dir": speech}]},
                              "num_workers": 1}}}
    ds, loader = get_dataset_dataloader(HParams(**cfg), "train", ["speech"])
    with pytest.raises(ValueError, match="bad wav entry"):
        next(iter(loader))
