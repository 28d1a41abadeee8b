"""Corpus-sampling building blocks for the test-set synthesizer.

The port's scripts/data/corpus_utils.py (reference: scripts/data/utils.py
:61-426): directory walkers with include/exclude/tsv lists, the
concat-with-silence audio builder with active-RMS normalization to -25
dBFS, CSV-driven RIR sampling with onset cross-check, and the AEC
Challenge farend/echo pair samplers. Every draw comes from the
`random.Random` the caller passes (`rng`), in the order the JAX package's
copy draws from the stdlib's module-level `random`: one generator seeded
as that module was gives the same draws.
"""
from __future__ import annotations

import math
import os
import random
import typing as tp

import numpy as np

MAXTRIES = 50
TARGET_DB_FOR_LOADING = -25

AUDIO_EXT = (".wav", ".WAV", ".flac", ".FLAC", ".mp3")


def is_audiofile(file: str) -> bool:
    return file.endswith(AUDIO_EXT)


def match_length(x: np.ndarray, target: int) -> np.ndarray:
    if len(x) < target:
        return np.pad(x, (0, target - len(x)))
    return x[:target]


class Directories:
    """Weighted file pool over directories and/or tsv filelists.

    Each include entry is a directory walked recursively (honoring
    exclude dirs/files) or a .tsv whose first column lists files relative
    to the tsv's parent. `extension=""` accepts any audio extension;
    otherwise files are stored without the extension suffix (reference
    :62-141). `mix` maps sibling pool names to probabilities for
    DirectoriesDataset's two-pool mixture draw.
    """

    def __init__(self, directories_to_include, directories_to_exclude=(),
                 extension: str = "", mix=None, files_to_exclude=()):
        self.extension = extension
        self.names_to_mix: tp.List[str] = []
        self.probabilities: tp.List[float] = []
        if mix:
            for name, prob in dict(mix).items():
                self.names_to_mix.append(name)
                self.probabilities.append(float(prob))
            rest = 1.0 - sum(self.probabilities)
            if rest < -1e-9:
                # random.choices silently accepts a negative weight and
                # draws from the wrong pools — fail fast instead
                raise ValueError(
                    f"mix probabilities sum to {sum(self.probabilities):g} "
                    "> 1; the remainder is the no-mix weight")
            self.names_to_mix.append("")
            self.probabilities.append(max(rest, 0.0))
        files_to_exclude = {os.path.abspath(f) for f in files_to_exclude}
        exclude = [os.path.abspath(d) for d in directories_to_exclude]

        # keyed by the ORIGINAL include entry (a dir path or a .tsv path):
        # two .tsv filelists in the same directory must not overwrite each
        # other, so the key is the entry and the join base is stored with
        # the list
        self.dir_filelist: tp.Dict[str, tp.Tuple[str, tp.List[str]]] = {}
        self.total_lengths = 0
        lengths = {}
        for entry in directories_to_include:
            directory = entry
            file_list = []
            if directory.endswith(".tsv"):
                tsv_base = os.path.dirname(directory)
                with open(directory) as f:
                    for line in f:
                        file = line.strip().split("\t")[0]
                        if not file:
                            continue
                        full = os.path.abspath(os.path.join(tsv_base, file))
                        if full in files_to_exclude:
                            continue
                        if extension == "":
                            if is_audiofile(file):
                                file_list.append(file)
                        elif file.endswith(extension):
                            file_list.append(file[: -len(extension)])
                directory = tsv_base
            else:
                for root, _, files in os.walk(directory, followlinks=True):
                    absroot = os.path.abspath(root)
                    if any(absroot == d or absroot.startswith(d + os.sep)
                           for d in exclude):
                        continue
                    for file in files:
                        full = os.path.join(absroot, file)
                        if full in files_to_exclude:
                            continue
                        rel = os.path.relpath(
                            os.path.join(root, file), directory)
                        if extension == "":
                            if is_audiofile(rel):
                                file_list.append(rel)
                        elif rel.endswith(extension):
                            file_list.append(rel[: -len(extension)])
            if not file_list:
                raise RuntimeError(
                    f"Directory {entry} has no matching files")
            file_list.sort()
            self.dir_filelist[entry] = (directory, file_list)
            self.total_lengths += len(file_list)
            lengths[entry] = len(file_list)
        self.lengths = dict(sorted(lengths.items()))

    def __len__(self) -> int:
        return self.total_lengths

    def choice(self, rng: random.Random) -> str:
        idx = rng.randrange(self.total_lengths)
        cumsum = 0
        for entry, length in self.lengths.items():
            if idx < cumsum + length:
                base, files = self.dir_filelist[entry]
                return os.path.join(
                    base, files[idx - cumsum] + self.extension)
            cumsum += length
        raise RuntimeError(self.lengths, self.total_lengths, idx)


class DirectoriesDataset:
    """Concat-with-silence audio builder over named weighted pools.

    `directories` is {name: {directories_to_include, extension,
    probability[, directories_to_exclude, mix]}}. A call draws a pool,
    builds `duration` seconds by concatenating random-offset clips
    normalized to -25 dBFS active RMS separated by silence_length of
    silence, and (if the pool declares `mix`) overlays a second pool at a
    random gain (reference :152-275).
    """

    def __init__(self, directories, fs: int, silence_length: float,
                 activity_threshold_relative=None,
                 activity_threshold_absolute=None,
                 normalize_output: bool = True,
                 mix_random_gain=(-10.0, 10.0)):
        self.fs = fs
        self.silence_length = int(silence_length * fs)
        self.random_gain = tuple(mix_random_gain)
        self.threshold = {}
        if activity_threshold_relative is not None:
            self.threshold["relative_threshold_db"] = \
                activity_threshold_relative
        if activity_threshold_absolute is not None:
            self.threshold["absolute_threshold_db"] = \
                activity_threshold_absolute
        self.normalize_output = normalize_output
        self.loaders: tp.Dict[str, Directories] = {}
        self.directories: tp.List[Directories] = []
        self.probabilities: tp.List[float] = []
        cum_prob = 0.0
        for name, kwargs in directories.items():
            dirs = Directories(
                directories_to_include=kwargs["directories_to_include"],
                directories_to_exclude=kwargs.get(
                    "directories_to_exclude", []),
                extension=kwargs["extension"],
                mix=kwargs.get("mix", None),
                files_to_exclude=kwargs.get("files_to_exclude", ()))
            self.loaders[name] = dirs
            self.directories.append(dirs)
            self.probabilities.append(float(kwargs["probability"]))
            cum_prob += float(kwargs["probability"])
        assert math.isclose(cum_prob, 1.0), \
            f"pool probabilities sum to {cum_prob}, expected 1.0"

    def _active_rms(self, wav: np.ndarray) -> float:
        from ..audiolib import active_rms_relative

        return active_rms_relative(wav, self.fs, **self.threshold)

    def normalize(self, wav: np.ndarray) -> np.ndarray:
        if not self.normalize_output:
            return wav
        from ..audiolib import normalize_segmental_rms

        rms = self._active_rms(wav)
        if rms > 0.0:
            wav = normalize_segmental_rms(wav, rms, TARGET_DB_FOR_LOADING)
        return wav

    def load_wav(self, directories: Directories, duration_to_load: float,
                 rng: random.Random) -> tp.Tuple[np.ndarray, str]:
        from ...data.audio_io import read_audio, wav_info

        for _ in range(10):
            filepath = directories.choice(rng)
            try:
                # decode only the crop window: with hour-long noise scenes
                # a full decode per draw makes test-set synthesis
                # quadratic-ish in file length (headers give the duration)
                offset_sec = 0.0
                if filepath.lower().endswith(".wav"):
                    frames, fsr = wav_info(filepath)
                    spare = frames / fsr - duration_to_load
                    if spare > 0:
                        offset_sec = rng.uniform(0.0, spare)
                wav, _ = read_audio(filepath, sr=self.fs, offset=offset_sec,
                                    duration=duration_to_load)
                want = int(duration_to_load * self.fs)
                if len(wav) > want:
                    offset = rng.randrange(len(wav) - want + 1)
                    wav = wav[offset: offset + want]
                return self.normalize(wav), filepath
            except Exception:
                continue
        raise RuntimeError(f"10 times failed to load wav from {directories}")

    def build_audio(self, dirs: Directories, duration: float,
                    rng: random.Random):
        out = np.zeros(0, np.float32)
        remaining = int(duration * self.fs)
        tries_left = MAXTRIES
        paths = []
        while remaining > 0 and tries_left > 0:
            tries_left -= 1
            clip, path = self.load_wav(dirs, remaining / self.fs, rng)
            paths.append(path)
            clip = clip[:remaining]
            out = np.append(out, clip)
            remaining -= len(clip)
            if remaining > 0:
                n_sil = min(remaining, self.silence_length)
                out = np.append(out, np.zeros(n_sil, np.float32))
                remaining -= n_sil
        return out, paths

    def __call__(self, duration: float, rng: random.Random
                 ) -> tp.Tuple[np.ndarray, str]:
        idx = rng.choices(range(len(self.directories)),
                          weights=self.probabilities)[0]
        dirs = self.directories[idx]
        wav, paths = self.build_audio(dirs, duration, rng)
        if dirs.names_to_mix:
            name = rng.choices(dirs.names_to_mix,
                               weights=dirs.probabilities)[0]
            if name:
                wav2, paths2 = self.build_audio(self.loaders[name], duration,
                                                rng)
                gain = 10 ** (rng.uniform(*self.random_gain) / 20)
                wav = wav + match_length(wav2, len(wav)) * gain
                wav = self.normalize(wav)
                paths = paths + paths2
        return wav, ",".join(paths)


class ReverbDataset:
    """CSV-driven RIR sampler: {name: {csv, base_dir, prob}} pools, each
    CSV row `path,channel,t60[,...]` (1-indexed channel). Returns
    (rir, t60, onset_sample) with the spectral/heuristic onset
    cross-check warning (reference :283-327)."""

    def __init__(self, fs: int, hps):
        self.fs = fs
        self.loaders = []
        self.probabilities = []
        cum_prob = 0.0
        for _, kwargs in dict(hps).items():
            with open(kwargs["csv"]) as f:
                filelists = [line.strip().split(",")
                             for line in f.readlines()[1:] if line.strip()]
            self.loaders.append({"base_dir": kwargs["base_dir"],
                                 "filelists": filelists})
            self.probabilities.append(float(kwargs["prob"]))
            cum_prob += float(kwargs["prob"])
        assert math.isclose(cum_prob, 1.0), \
            f"RIR pool probabilities sum to {cum_prob}, expected 1.0"

    def __call__(self, rng: random.Random
                 ) -> tp.Tuple[np.ndarray, float, int]:
        from ...data.audio_io import read_audio
        from ..audiolib import find_rir_onset_spectral, get_rir_start_sample

        loader = rng.choices(self.loaders, weights=self.probabilities)[0]
        path, ch, t60, *_ = rng.choice(loader["filelists"])
        full = os.path.join(loader["base_dir"], path)
        rir, rir_fs = read_audio(full, mono=False)
        if rir.ndim > 1:
            rir = rir[int(ch) - 1]
        if rir_fs != self.fs:
            raise ValueError(
                f"RIR sampling rate {rir_fs} != target {self.fs}: {full}")
        onset = int(find_rir_onset_spectral(rir, rir_fs))
        heuristic = int(get_rir_start_sample(rir))
        if abs(onset - heuristic) > 0.001 * self.fs:
            print(f"Onset mismatch for {full} channel {ch}: "
                  f"spectral={onset} vs heuristic={heuristic}")
        return rir, float(t60), onset


class AECChallengeReal:
    """Recorded farend/echo pairs from tsv lists `farend\\techo\\tncc`,
    filtered by NCC threshold; SER drawn from range(lo, hi+1, step)
    (reference :330-365)."""

    def __init__(self, hps):
        lo, hi, step = hps["farend"]["aec_challenge_real"]["ser"]
        self.ser_list = [float(s) for s in range(lo, hi + 1, step)]
        self.farend_echo_list = []
        ncc_threshold = hps["farend"]["aec_challenge_real"]["ncc_threshold"]
        for hp in hps["input"]["farend"]["aec_challenge_real"]:
            base_dir = hp["base_dir"]
            with open(hp["tsv"]) as f:
                lines = f.readlines()[1:]
            for line in lines:
                farend, echo, ncc = line.strip().split("\t")
                if float(ncc) >= ncc_threshold:
                    self.farend_echo_list.append(
                        (os.path.join(base_dir, farend),
                         os.path.join(base_dir, echo)))

    def __call__(self, length_target: int, rng: random.Random):
        from ...data.audio_io import read_audio

        farend_path, echo_path = rng.choice(self.farend_echo_list)
        farend = match_length(read_audio(farend_path)[0], length_target)
        echo = match_length(read_audio(echo_path)[0], length_target)
        return farend, echo, rng.choice(self.ser_list)


class AECChallengeSynthetic:
    """Synthetic pairs `farend_speech/farend_speech_fileid_{i}.wav` +
    `echo_signal/echo_fileid_{i}.wav`, i in [lower, upper]
    (reference :368-398)."""

    def __init__(self, hps):
        lo, hi, step = hps["farend"]["aec_challenge_synthetic"]["ser"]
        self.ser_list = [float(s) for s in range(lo, hi + 1, step)]
        hp = hps["input"]["farend"]["aec_challenge_synthetic"]
        self.base_dir = hp["base_dir"]
        self.idx_lower = hp["id"]["lower"]
        self.idx_upper = hp["id"]["upper"]

    def __call__(self, length_target: int, rng: random.Random):
        from ...data.audio_io import read_audio

        idx = rng.randint(self.idx_lower, self.idx_upper)
        farend = read_audio(os.path.join(
            self.base_dir, "farend_speech",
            f"farend_speech_fileid_{idx}.wav"))[0]
        echo = read_audio(os.path.join(
            self.base_dir, "echo_signal", f"echo_fileid_{idx}.wav"))[0]
        assert len(farend) == len(echo), \
            f"Length mismatch between farend and echo for idx {idx}"
        farend = match_length(farend, length_target)
        echo = match_length(echo, length_target)
        return farend, echo, rng.choice(self.ser_list)


class Farend:
    """Farend/echo presence sampler: draws (farend_exists, echo_exists)
    from prob.farend_echo / prob.farend_only, then a real-vs-synthetic
    AEC pair (reference :401-426)."""

    def __init__(self, hps):
        self.fs = hps["fs"]
        self.prob_farend_echo = hps["farend"]["prob"]["farend_echo"]
        self.prob_farend_only = hps["farend"]["prob"]["farend_only"]
        self.prob_real = hps["farend"]["aec_challenge_real"]["prob"]
        prob_synth = hps["farend"]["aec_challenge_synthetic"]["prob"]
        assert math.isclose(self.prob_real + prob_synth, 1.0), \
            "real + synthetic farend probabilities must sum to 1.0"
        self.dataset_real = AECChallengeReal(hps)
        self.dataset_synthetic = AECChallengeSynthetic(hps)

    def __call__(self, duration: float, rng: random.Random):
        """-> (farend, echo, ser, farend_type, farend_exists, echo_exists)"""
        p = rng.random()
        if p < self.prob_farend_echo:
            farend_exists, echo_exists = True, True
        elif p < self.prob_farend_echo + self.prob_farend_only:
            farend_exists, echo_exists = True, False
        else:
            farend_exists, echo_exists = False, False
        length_target = int(duration * self.fs)
        if rng.random() < self.prob_real:
            farend, echo, ser = self.dataset_real(length_target, rng)
            farend_type = "real"
        else:
            farend, echo, ser = self.dataset_synthetic(length_target, rng)
            farend_type = "synthetic"
        return farend, echo, ser, farend_type, farend_exists, echo_exists
