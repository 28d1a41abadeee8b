"""Mel filterbanks (numpy): the `mel*` pre_post_init of the dptransformer
model, and the log-mel images of the training summaries.

Copy of fastenhancer_tpu/functional/mel.py: `mel_fbank_weights` is the
slaney-normalized HTK-mel filterbank scaled by f_n/freq, with its
pseudo-inverse and one-hot patching of empty rows (reference:
models/fastenhancer/dprnn/model.py:263-298); `spec_to_mel` renders the
log-mel image of a magnitude spectrogram on the host.
"""
from __future__ import annotations

import functools
import math
import typing as tp

import numpy as np


def mel_fbank_weights(freq: int, n_filter: int, sr: int
                      ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """[n_filter, freq] mel filterbank + [freq, n_filter] pinv inverse."""
    f_n = sr // 2
    all_freqs = np.linspace(0, f_n, freq)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(f_n), n_filter + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [freq, n_filter+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # [freq, n_filter]
    enorm = 2.0 / (f_pts[2: n_filter + 2] - f_pts[:n_filter])  # slaney norm
    fb = fb * enorm[None, :]
    mel_fb = fb.T * f_n / freq  # [n_filter, freq]

    # the reference patches empty rows via base-e mel with 1127
    def mel_to_hz_e(mel: float) -> float:
        return 700.0 * (math.e ** (mel / 1127.0) - 1.0)

    mel_max = float(hz_to_mel(f_n))
    for idx in range(n_filter):
        if np.isclose(mel_fb[idx].sum(), 0.0):
            idx_f = round(mel_to_hz_e(idx / n_filter * mel_max) * freq / f_n)
            mel_fb[idx, min(max(idx_f, 0), freq - 1)] = 1.0
    mel_fb_inv = np.linalg.pinv(mel_fb)
    for idx in range(freq):
        if np.isclose(mel_fb_inv[idx].sum(), 0.0):
            idx_mel = round(float(hz_to_mel(idx / freq * f_n))
                            * n_filter / mel_max)
            mel_fb_inv[idx, min(max(idx_mel, 0), n_filter - 1)] = 1.0
    return mel_fb.astype(np.float32), mel_fb_inv.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_fbank(n_freq: int, n_mels: int, sr: int) -> np.ndarray:
    pre, _ = mel_fbank_weights(n_freq, n_mels, sr)
    return pre  # [n_mels, n_freq]


def spec_to_mel(mag: np.ndarray, n_mels: int = 80, sr: int = 16_000,
                eps: float = 1e-5) -> np.ndarray:
    """magnitude [F, T] -> log-mel [n_mels, T] (numpy, host side)."""
    fb = _mel_fbank(mag.shape[0], n_mels, sr)
    return np.log10(fb @ np.asarray(mag) + eps)


__all__ = ["mel_fbank_weights", "spec_to_mel"]
