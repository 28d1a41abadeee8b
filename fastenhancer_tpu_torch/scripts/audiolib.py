"""Audio measurement helpers for dataset preparation.

The port's scripts/audiolib.py (reference: scripts/audiolib.py:9-165):
active RMS, segmental normalization, and the RIR onset finders the shard
builders under `scripts/data/` use. Plain numpy, the same statements as
the JAX package's copy, so both give equal results on equal inputs.
"""
from __future__ import annotations

import typing as tp

import numpy as np

EPS = np.finfo(np.float32).eps


def active_rms_relative(
    audio: np.ndarray,
    sr: int = 16_000,
    window_ms: int = 100,
    relative_threshold_db: float = -25.0,
    absolute_threshold_db: tp.Optional[float] = -50.0,
) -> float:
    """Active-segment RMS (host/numpy mirror of ops.segmental_rms).

    Statistic and edge cases match the reference
    (scripts/audiolib.py:142-165): the mean of active segments' RMS values,
    0.0 when the signal is shorter than one window or has no active
    segment (callers skip rms == 0.0 items)."""
    win = int(sr * window_ms / 1000)
    n = len(audio) // win
    if n == 0:
        return 0.0
    seg_rms = np.sqrt(np.mean(np.square(audio[: n * win]).reshape(n, win),
                              axis=1))
    thr = seg_rms.max() * 10.0 ** (relative_threshold_db / 20.0)
    if absolute_threshold_db is not None:
        thr = max(thr, 10.0 ** (absolute_threshold_db / 20.0))
    active = seg_rms > thr
    if not active.any():
        return 0.0
    return float(seg_rms[active].mean())


def normalize_segmental_rms(audio: np.ndarray, rms: float,
                            target_level_db: float = -25.0) -> np.ndarray:
    scalar = 10.0 ** (target_level_db / 20.0) / (rms + EPS)
    return audio * scalar


def get_rir_start_sample(rir: np.ndarray, threshold_db: float = -20.0) -> int:
    """First sample within threshold_db of the RIR peak
    (reference: scripts/audiolib.py direct-path onset)."""
    peak = np.abs(rir).max()
    if peak == 0:
        return 0
    thr = peak * 10.0 ** (threshold_db / 20.0)
    idx = np.nonzero(np.abs(rir) >= thr)[0]
    return int(idx[0]) if idx.size else 0


def find_rir_onset_spectral(rir: np.ndarray, sr: int = 16_000,
                            frame: int = 64) -> int:
    """Energy-flux onset: first frame whose energy jumps by >10x over the
    running floor (robust to pre-ring; reference spectral-onset analog)."""
    n = len(rir) // frame
    if n < 2:
        return get_rir_start_sample(rir)
    e = np.square(rir[: n * frame]).reshape(n, frame).sum(axis=1) + EPS
    floor = np.minimum.accumulate(np.maximum.accumulate(e) * 1e-6 + e.min())
    jumps = np.nonzero(e > 10.0 * np.maximum(floor, e.mean() * 1e-3))[0]
    if jumps.size == 0:
        return get_rir_start_sample(rir)
    start = jumps[0] * frame
    return start + get_rir_start_sample(rir[start: start + 4 * frame])


def estimate_t60(rir: np.ndarray, sr: int = 16_000) -> float:
    """Schroeder backward-integration T60 estimate (T20 x 3 fit)."""
    energy = np.square(rir.astype(np.float64))
    edc = np.cumsum(energy[::-1])[::-1]
    edc = 10.0 * np.log10(edc / (edc[0] + EPS) + EPS)
    # fit the -5 dB .. -25 dB segment
    i5 = np.argmax(edc <= -5.0)
    i25 = np.argmax(edc <= -25.0)
    if i25 <= i5:
        return 0.5
    slope = (edc[i25] - edc[i5]) / (i25 - i5)  # dB per sample
    if slope >= 0:
        return 0.5
    return float(-60.0 / slope / sr)


def vad_segments(
    audio: np.ndarray,
    sr: int = 16_000,
    frame_ms: float = 32.0,
    threshold_db: float = -35.0,
    min_speech_sec: float = 0.5,
    max_gap_sec: float = 0.5,
    pad_sec: float = 0.2,
) -> list:
    """Energy-VAD segmentation of a long recording into utterances.

    Analog of the reference's segment_daps.py / segment_ears.py (:1-5),
    which split studio recordings with VAD before sharding. Frames whose
    power exceeds `threshold_db` relative to the recording's active RMS are
    speech; runs separated by gaps <= max_gap_sec are merged; segments
    shorter than min_speech_sec are dropped; boundaries are padded by
    pad_sec. Returns [(start_sample, end_sample), ...].
    """
    frame = max(int(sr * frame_ms / 1000), 1)
    n = len(audio) // frame
    if n == 0:
        return []
    pow_f = (audio[: n * frame].reshape(n, frame) ** 2).mean(axis=1)
    ref = active_rms_relative(audio, sr=sr) ** 2
    if ref <= 0.0:
        # no frame cleared the absolute activity floor (silent/near-silent
        # recording): no speech segments — without this, ref=0 would mark
        # every nonzero noise-floor frame as speech
        return []
    active = pow_f > ref * (10.0 ** (threshold_db / 10.0))

    segs = []
    start = None
    gap_frames = int(max_gap_sec * sr / frame)
    silent = 0
    for i, a in enumerate(active):
        if a:
            if start is None:
                start = i
            silent = 0
        elif start is not None:
            silent += 1
            if silent > gap_frames:
                segs.append((start, i - silent + 1))
                start = None
                silent = 0
    if start is not None:
        segs.append((start, n))

    pad = int(pad_sec * sr)
    out = []
    for s, e in segs:
        s0, e0 = s * frame, e * frame
        if (e0 - s0) / sr < min_speech_sec:
            continue
        out.append((max(s0 - pad, 0), min(e0 + pad, len(audio))))
    return out
