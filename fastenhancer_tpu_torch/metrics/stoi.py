"""STOI / ESTOI objective intelligibility, implemented from the papers.

STOI: Taal et al., "An Algorithm for Intelligibility Prediction of
Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011.
ESTOI: Jensen & Taal, "An Algorithm for Predicting the Intelligibility of
Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016.

A copy of fastenhancer_tpu/metrics/stoi.py (the port imports nothing of the
JAX package): an independent numpy implementation of the published
algorithms, in place of the pystoi package (same constants as the papers and
pystoi: fs 10 kHz, 256-pt frames, hop 128, 15 third-octave bands from
150 Hz, 384 ms segments, -15 dB SDR clip, 40 dB silence threshold).
"""
from __future__ import annotations

import functools
import typing as tp

import numpy as np

from ..data.audio_io import resample

FS = 10_000
N_FRAME = 256
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG = 30  # frames per analysis segment (384 ms)
BETA = -15.0  # lower SDR bound (dB)
DYN_RANGE = 40.0  # silence removal threshold (dB)


@functools.lru_cache(maxsize=None)
def _third_octave_matrix() -> np.ndarray:
    """[NUM_BANDS, NFFT//2+1] boolean band matrix."""
    f = np.linspace(0, FS, NFFT, endpoint=False)[: NFFT // 2 + 1]
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = MIN_FREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        lo_idx = int(np.argmin(np.square(f - lo[i])))
        hi_idx = int(np.argmin(np.square(f - hi[i])))
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _frames(x: np.ndarray) -> np.ndarray:
    """[T] -> [N, 256] hann-windowed frames, hop 128."""
    n = (len(x) - N_FRAME) // HOP + 1
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(n)[:, None] * HOP + np.arange(N_FRAME)[None, :]
    w = np.hanning(N_FRAME + 2)[1:-1]
    return x[idx] * w


def _remove_silent_frames(x: np.ndarray, y: np.ndarray
                          ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Drop frames whose clean energy is > DYN_RANGE below the max, then
    overlap-add back to waveforms (paper sec. II-A)."""
    xf = _frames(x)
    yf = _frames(y)
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-16)
    mask = energy > (energy.max() - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    n = len(xf)
    out_len = (n - 1) * HOP + N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * HOP: i * HOP + N_FRAME] += xf[i]
        ys[i * HOP: i * HOP + N_FRAME] += yf[i]
    return xs, ys


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    """[T] -> [NUM_BANDS, N] third-octave magnitude envelopes."""
    frames = _frames(x)
    spec = np.fft.rfft(frames, NFFT, axis=1)  # [N, NFFT//2+1]
    power = np.square(np.abs(spec))
    obm = _third_octave_matrix()
    return np.sqrt(power @ obm.T).T  # [bands, N]


def stoi(clean: np.ndarray, enhanced: np.ndarray, sr: int,
         extended: bool = False) -> float:
    """STOI (or ESTOI) of `enhanced` against `clean`; both 1-D, same length."""
    x = np.asarray(clean, np.float64)
    y = np.asarray(enhanced, np.float64)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if sr != FS:
        x = resample(x, sr, FS).astype(np.float64)
        y = resample(y, sr, FS).astype(np.float64)
    x, y = _remove_silent_frames(x, y)
    X = _band_envelopes(x)  # [J, N]
    Y = _band_envelopes(y)
    n_frames = X.shape[1]
    if n_frames < SEG:
        return float("nan")

    if not extended:
        c = 10.0 ** (-BETA / 20.0)
        corrs = []
        for m in range(SEG, n_frames + 1):
            Xm = X[:, m - SEG: m]  # [J, SEG]
            Ym = Y[:, m - SEG: m]
            alpha = (np.linalg.norm(Xm, axis=1, keepdims=True)
                     / (np.linalg.norm(Ym, axis=1, keepdims=True) + 1e-16))
            Yp = np.minimum(Ym * alpha, Xm * (1.0 + c))
            xn = Xm - Xm.mean(axis=1, keepdims=True)
            yn = Yp - Yp.mean(axis=1, keepdims=True)
            num = (xn * yn).sum(axis=1)
            den = (np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1)
                   + 1e-16)
            corrs.append(num / den)
        return float(np.mean(corrs))

    # ESTOI: row- and column-normalized segment correlation
    vals = []
    for m in range(SEG, n_frames + 1):
        Xm = X[:, m - SEG: m]
        Ym = Y[:, m - SEG: m]
        # normalize rows (bands over time)
        Xr = Xm - Xm.mean(axis=1, keepdims=True)
        Xr = Xr / (np.linalg.norm(Xr, axis=1, keepdims=True) + 1e-16)
        Yr = Ym - Ym.mean(axis=1, keepdims=True)
        Yr = Yr / (np.linalg.norm(Yr, axis=1, keepdims=True) + 1e-16)
        # normalize columns (spectra per frame)
        Xc = Xr - Xr.mean(axis=0, keepdims=True)
        Xc = Xc / (np.linalg.norm(Xc, axis=0, keepdims=True) + 1e-16)
        Yc = Yr - Yr.mean(axis=0, keepdims=True)
        Yc = Yc / (np.linalg.norm(Yc, axis=0, keepdims=True) + 1e-16)
        vals.append((Xc * Yc).sum() / SEG)
    return float(np.mean(vals))


def estoi(clean: np.ndarray, enhanced: np.ndarray, sr: int) -> float:
    return stoi(clean, enhanced, sr, extended=True)
