"""Shared energy-VAD chunker + CLI harness for the corpus segmenters.

The port's scripts/data/segment_vad.py. The reference ships two
near-identical segmentation scripts (scripts/data/segment_daps.py,
segment_ears.py) that cut studio recordings into utterance-sized chunks:
100 ms frames are speech/silence classified by RMS against -40 dB of the
file's peak frame RMS; a chunk starts at speech onset, must reach
--min-dur, is cut at the first silence frame before --max-dur (force-cut
at max), both ends padded with --pad-ms of surrounding silence, and a file
tail shorter than --tail-min is discarded (reference:
scripts/data/segment_daps.py:40-101, segment_ears.py:27-103). This module
reimplements that contract once (vectorized frame RMS) and the two CLIs
plug corpus quirks into `run_segmenter`, whose pool is spawned.
"""
from __future__ import annotations

import functools
import multiprocessing
import os
import typing as tp
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def frame_rms(x: np.ndarray, hop: int) -> np.ndarray:
    n = max(len(x) // hop, 1)
    if len(x) < n * hop:
        x = np.pad(x, (0, n * hop - len(x)))
    return np.sqrt((x[: n * hop].reshape(n, hop).astype(np.float64) ** 2)
                   .mean(axis=1))


def segment_chunks(
    audio: np.ndarray,
    sr: int,
    min_dur: float = 3.0,
    max_dur: float = 10.0,
    hop_ms: int = 100,
    tail_min: float = 1.0,
    pad_ms: int = 200,
    highpass_hz: tp.Optional[float] = None,
) -> tp.List[np.ndarray]:
    """Cut `audio` into chunks per the reference contract (see module doc).

    highpass_hz: apply a 4th-order Butterworth high-pass to the VAD signal
    only (the EARS variant uses 80 Hz so room rumble doesn't count as
    activity, reference: segment_ears.py:41-44); output chunks always come
    from the original audio.
    """
    hop = int(hop_ms / 1000 * sr)
    pad = int(pad_ms / 1000 * sr)
    vad_sig = audio
    if highpass_hz:
        from scipy.signal import butter, sosfilt

        sos = butter(4, highpass_hz / (sr / 2), btype="high", output="sos")
        vad_sig = sosfilt(sos, audio).astype(np.float32)
    rms = frame_rms(vad_sig, hop)
    n_frames = len(rms)
    peak = rms.max() if rms.max() > 0 else 1.0
    silence = rms < peak * 0.01  # -40 dB relative to the peak frame

    min_s, max_s = int(min_dur * sr), int(max_dur * sr)
    tail_s = int(tail_min * sr)
    chunks: tp.List[np.ndarray] = []
    start = 0
    while start < len(audio):
        # speech onset: skip silence frames
        fr = start // hop
        while fr < n_frames and silence[fr]:
            fr += 1
        onset = fr * hop
        remaining = len(audio) - onset
        if remaining < tail_s:
            break  # discard short tail
        # frames in [start, onset) are silent, so padding back is safe
        c0 = max(start, onset - pad)
        if remaining <= max_s:
            chunks.append(audio[c0:])
            break
        # first silence frame in the [min_dur, max_dur] window, else force
        lo = (onset + min_s) // hop
        hi = min((onset + max_s) // hop, n_frames - 1)
        win = np.nonzero(silence[lo: hi + 1])[0]
        cut = (lo + win[0]) * hop if len(win) else onset + max_s
        # pad the tail with silence, stopping at the next active frame
        pe = min(n_frames, (cut + pad) // hop + 1)
        act = np.nonzero(~silence[cut // hop: pe])[0]
        c1 = ((cut // hop + act[0]) * hop if len(act)
              else min(len(audio), cut + pad))
        chunks.append(audio[c0:c1])
        start = cut
    return chunks


def write_wav_any(path: str, x: np.ndarray, sr: int,
                  subtype: str = "pcm16") -> None:
    """Write mono float audio as PCM16 or IEEE float32 (the EARS
    segmenter stores float to avoid re-quantizing studio masters), through
    the data layer's one wav encoder, shar_writer.wav_bytes."""
    from .shar_writer import wav_bytes

    assert subtype in ("pcm16", "float32"), subtype
    with open(path, "wb") as f:
        f.write(wav_bytes(np.asarray(x, np.float32), sr,
                          float32=subtype == "float32"))


def _segment_one(job, src_dir, out_dir, preserve_dirs, subtype, kw):
    """(path) -> (name, n_segments | -1, total_samples | error)."""
    path = job
    from ...data.audio_io import read_wav

    try:
        audio, sr = read_wav(path)
        chunks = segment_chunks(audio, sr, **kw)
        rel = os.path.relpath(path, src_dir)
        sub = os.path.dirname(rel) if preserve_dirs else ""
        base = os.path.splitext(os.path.basename(path))[0]
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        for i, c in enumerate(chunks):
            write_wav_any(os.path.join(d, f"{base}_{i:04d}.wav"), c, sr,
                          subtype)
        return path, len(chunks), sum(len(c) for c in chunks), sr
    except Exception as e:  # report per-file errors, keep going
        return path, -1, str(e), 0


def run_segmenter(files: tp.Sequence[str], src_dir: str, out_dir: str,
                  num_workers: int = 4, preserve_dirs: bool = False,
                  subtype: str = "pcm16", dry_run: bool = False,
                  **chunk_kw) -> tp.Tuple[int, float]:
    """Pool-segment `files`; returns (n_segments, total_seconds)."""
    print(f"Found {len(files)} wav files in {src_dir}")
    if dry_run:
        for f in files:
            print(" ", os.path.relpath(f, src_dir))
        return 0, 0.0
    os.makedirs(out_dir, exist_ok=True)
    total_segs, total_sec = 0, 0.0
    work = functools.partial(_segment_one, src_dir=src_dir, out_dir=out_dir,
                             preserve_dirs=preserve_dirs, subtype=subtype,
                             kw=chunk_kw)
    if num_workers > 1:
        with ProcessPoolExecutor(
                num_workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(work, files))
    else:
        results = [work(f) for f in files]
    for name, n, payload, sr in results:
        if n == -1:
            print(f"  ERROR {name}: {payload}")
        else:
            total_segs += n
            total_sec += payload / max(sr, 1)
    h, rem = divmod(int(total_sec), 3600)
    print(f"Done. {total_segs} segments, total audio {h}h{rem // 60:02d}m "
          f"-> {out_dir}")
    return total_segs, total_sec
