"""Audio file IO without librosa/soundfile: stdlib `wave` + numpy.

A copy of fastenhancer_tpu/data/audio_io.py (the port imports nothing of
the JAX package). PCM 8/16/24/32-bit and IEEE-float wavs are decoded to
float32 in [-1, 1], a whole mono read by the native library
(`fastenhancer_tpu_torch/native`) where it is available, else by numpy;
resampling is polyphase (scipy.signal.resample_poly).
"""
from __future__ import annotations

import struct
import typing as tp
import wave

import numpy as np


def read_wav(path: str, sr: tp.Optional[int] = None,
             mono: bool = True, offset: float = 0.0,
             duration: tp.Optional[float] = None) -> tp.Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 [-1,1], sample_rate).

    mono=True (default) averages multi-channel audio to mono
    (librosa.load default behavior) and returns [T]; mono=False keeps
    channels and returns [C, T] (the noise shard builders chunk per
    channel, reference: scripts/data/shard_noise.py:85-101). If `sr` is
    given and differs from the file rate, resample (along time).

    offset/duration (seconds, librosa.load semantics) read only that
    window of the file — the reader seeks inside the data chunk instead
    of decoding the whole file, so drawing short crops from hour-long
    recordings stays O(window).
    """
    from .. import native

    windowed = offset > 0.0 or duration is not None
    if mono and not windowed and native.available():
        x, file_sr = native.read_wav_file(path)  # native decodes to mono
    else:
        with open(path, "rb") as fh:
            header = fh.read(12)
            if header[:4] == b"RIFF" and header[8:12] == b"WAVE":
                x, file_sr = _read_riff(fh, offset=offset, duration=duration)
            else:
                raise ValueError(f"not a RIFF/WAVE file: {path}")
    if x.ndim == 2:
        x = x.mean(axis=1) if mono else np.ascontiguousarray(x.T)
    if sr is not None and sr != file_sr:
        x = resample(x, file_sr, sr)
        file_sr = sr
    return x, file_sr


def wav_info(path: str) -> tp.Tuple[int, int]:
    """(n_frames, sample_rate) from the headers alone — no sample decode."""
    with open(path, "rb") as fh:
        header = fh.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            head = fh.read(8)
            if len(head) < 8:
                break
            cid, size = struct.unpack("<4sI", head)
            if cid == b"fmt ":
                fmt = fh.read(size)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError("data chunk precedes fmt")
                _, n_ch, sr_, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
                frame_bytes = max(n_ch, 1) * max(bits // 8, 1)
                return size // frame_bytes, sr_
            else:
                fh.seek(size + (size & 1), 1)
    raise ValueError("missing fmt/data chunk")


def _read_riff(fh, offset: float = 0.0,
               duration: tp.Optional[float] = None) -> tp.Tuple[np.ndarray, int]:
    """Parse fmt/data chunks; supports PCM (1), IEEE float (3), extensible.
    offset/duration (seconds) restrict the read to a frame window via a
    seek into the data chunk."""
    fmt = None
    data = None
    window_applied = False
    while True:
        head = fh.read(8)
        if len(head) < 8:
            break
        cid, size = struct.unpack("<4sI", head)
        if cid == b"fmt ":
            fmt = fh.read(size)
        elif cid == b"data":
            if fmt is not None and (offset > 0.0 or duration is not None):
                window_applied = True
                _, n_ch_, sr_, _, _, bits_ = struct.unpack("<HHIIHH",
                                                           fmt[:16])
                frame_bytes = max(n_ch_, 1) * max(bits_ // 8, 1)
                n_frames = size // frame_bytes
                skip = min(int(offset * sr_), n_frames)
                take = n_frames - skip if duration is None else min(
                    int(duration * sr_), n_frames - skip)
                fh.seek(skip * frame_bytes, 1)
                data = fh.read(take * frame_bytes)
            else:
                data = fh.read(size)
        else:
            fh.seek(size + (size & 1), 1)
        if fmt is not None and data is not None:
            break
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real format in GUID
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    if audio_fmt == 3:  # IEEE float
        x = np.frombuffer(data, np.float32 if bits == 32 else np.float64)
        x = x.astype(np.float32)
    elif audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            ints = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported wav format code: {audio_fmt}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch)
    if (offset > 0.0 or duration is not None) and not window_applied:
        # degenerate chunk order (data before fmt): window post-decode
        skip = int(offset * sr)
        x = x[skip:] if duration is None else \
            x[skip: skip + int(duration * sr)]
    return x, sr


def read_audio(path: str, sr: tp.Optional[int] = None,
               mono: bool = True, offset: float = 0.0,
               duration: tp.Optional[float] = None) -> tp.Tuple[np.ndarray, int]:
    """read_wav for .wav paths; anything else (flac/mp3/...) decodes via
    soundfile when installed. offset/duration restrict the read window
    (seconds, librosa semantics)."""
    if path.lower().endswith(".wav"):
        return read_wav(path, sr=sr, mono=mono, offset=offset,
                        duration=duration)
    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError(
            f"decoding {path.rsplit('.', 1)[-1]} files needs the soundfile "
            f"package, which is not installed") from e
    if offset > 0.0 or duration is not None:
        info = sf.info(path)
        start = int(offset * info.samplerate)
        stop = None if duration is None else \
            start + int(duration * info.samplerate)
        x, file_sr = sf.read(path, dtype="float32", start=start, stop=stop)
    else:
        x, file_sr = sf.read(path, dtype="float32")
    if x.ndim == 2:
        x = x.mean(axis=1) if mono else np.ascontiguousarray(x.T)
    if sr is not None and sr != file_sr:
        x = resample(x, file_sr, sr)
        file_sr = sr
    return x, file_sr


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float [-1,1] mono/stereo as PCM16."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(x.shape[1])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def wav_duration(path: str) -> float:
    """Duration in seconds from the header only (fast length probing)."""
    with wave.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g, axis=-1
                         ).astype(np.float32)
