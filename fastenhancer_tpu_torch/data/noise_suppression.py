"""Paired clean/noisy dataset (Voicebank-Demand style).

A copy of fastenhancer_tpu/data/noise_suppression.py (the port imports
nothing of the JAX package):

  * map-style items keyed by wav stem; clean/noisy pairs by directory;
  * fixed random segment crop when segment_size is set (train/valid),
    center-pad when shorter;
  * when segment_size is None (pesq/infer): files sorted by duration so that
    consecutive batches hold similar lengths (minimal padding), and shuffle
    permutes whole batch-blocks only;
  * `shuffle(seed)` is stateless w.r.t. history — always re-derived from the
    pristine sorted order so that resume at epoch N reproduces the epoch-N
    order exactly.
"""
from __future__ import annotations

import os
import random
import typing as tp

import numpy as np

from .audio_io import read_wav, wav_duration

Item = tp.Dict[str, tp.Any]


class NSDataset:
    def __init__(self, hp, keys=None, textprocessor=None, mode="train",
                 batch_size=1, verbose=False):
        del textprocessor, verbose
        self.keys = list(keys) if keys else ["clean", "noisy"]
        self.sampling_rate = hp.sampling_rate
        self.clean_dir = hp[mode].clean_dir
        self.noisy_dir = hp[mode].noisy_dir
        self.segment_size = getattr(hp[mode], "segment_size", None)

        if mode == "infer":
            self.files = list(hp["infer"]["files"])
            self.segment_size = None
        else:
            self.files = sorted(
                x[:-4] for x in os.listdir(self.clean_dir) if x.endswith(".wav"))
        if mode == "pesq":
            self.segment_size = None
        self.files_sorted = list(self.files)

        self.transcript: tp.Dict[str, str] = {}
        if "transcript" in self.keys:
            with open(hp[mode]["transcript_dir"], "r") as f:
                for line in f:
                    name, text = line.strip().split("|")[:2]
                    self.transcript[name] = text

        if self.segment_size is None:
            self.batch_size = batch_size
            durations = [self._duration(i) for i in range(len(self.files))]
            order = np.argsort(np.asarray(durations), kind="stable")
            self.files_sorted = [self.files[i] for i in order]
            self.files = list(self.files_sorted)

    def _duration(self, idx: int) -> float:
        return wav_duration(os.path.join(self.clean_dir, f"{self.files[idx]}.wav"))

    def shuffle(self, seed: int) -> None:
        if self.segment_size is None:
            rng = np.random.default_rng(seed)
            bs = self.batch_size
            n_blocks = len(self.files) // bs
            perm = rng.permutation(n_blocks)
            head = np.asarray(self.files_sorted[: n_blocks * bs])
            head = head.reshape(n_blocks, bs)[perm].reshape(-1)
            self.files = list(head) + self.files_sorted[n_blocks * bs:]
        else:
            files = list(self.files_sorted)
            random.seed(seed)
            random.shuffle(files)
            self.files = files

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Item:
        name = self.files[idx]
        data: Item = {}
        x = None
        if "clean" in self.keys:
            x, sr = read_wav(os.path.join(self.clean_dir, f"{name}.wav"))
            assert sr == self.sampling_rate, (sr, self.sampling_rate)
            data["clean"] = x
        if "noisy" in self.keys:
            x, sr = read_wav(os.path.join(self.noisy_dir, f"{name}.wav"))
            assert sr == self.sampling_rate, (sr, self.sampling_rate)
            data["noisy"] = x
        if "wav_len" in self.keys:
            data["wav_len"] = len(x)

        if self.segment_size is not None and x is not None:
            n = len(x)
            if n < self.segment_size:
                pad = self.segment_size - n
                for k, v in data.items():
                    if isinstance(v, np.ndarray):
                        data[k] = np.pad(v, (pad // 2, pad - pad // 2))
            else:
                start = random.randrange(n - self.segment_size + 1)
                for k, v in data.items():
                    if isinstance(v, np.ndarray):
                        data[k] = v[start: start + self.segment_size]

        if "transcript" in self.keys:
            data["transcript"] = self.transcript[name]
        if "filename" in self.keys:
            data["filename"] = name
        return data
