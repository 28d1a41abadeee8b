"""Noise corpus -> shar shards, chunked (DNS noise, WHAM, TUT, FMA, ...).

The port's scripts/data/shard_noise.py, mirroring the reference's
scripts/data/shard_noise.py (:74-102): each (possibly multi-channel) noise
file is split per channel into --chunk-sec pieces; chunks shorter than
--min-sec are dropped; each chunk becomes a cut with `custom.rms`.

    python -m fastenhancer_tpu_torch.scripts.data.shard_noise -n dns -d \
        NOISE_DIR -s SHARD_ROOT [--fs 16000] [--chunk-sec 10] [--min-sec \
        9] [-j 8] [-f]
"""
import argparse
import functools

import numpy as np


def chunk_cuts(audio: np.ndarray, fs: int, base_id: str,
               chunk_sec: float, min_sec: float, channel: int = 0):
    """Split one channel into fixed chunks with active-RMS metadata
    (reference: shard_noise.py:85-101)."""
    from ..audiolib import active_rms_relative

    chunk = int(fs * chunk_sec)
    min_chunk = int(fs * min_sec)
    cuts = []
    start = 0
    idx = 0
    n = len(audio)
    while start < n:
        end = min(start + chunk, n)
        if end - start < min_chunk:
            break
        piece = audio[start:end]
        cuts.append({"id": f"{base_id}_ch{channel}_{idx}",
                     "audio": np.asarray(piece, np.float32), "sr": fs,
                     "custom": {"rms": float(active_rms_relative(piece, fs))}})
        start += chunk
        idx += 1
    return cuts


def process_noise_file(job, fs: int, chunk_sec: float, min_sec: float,
                       mono: bool):
    idx, path = job
    from ...data.audio_io import read_wav

    try:
        audio, _ = read_wav(path, sr=fs, mono=mono)
    except Exception as e:
        return f"Error processing {path}: {e}"
    audio = np.atleast_2d(audio)
    cuts = []
    for ch in range(audio.shape[0]):
        cuts.extend(chunk_cuts(audio[ch], fs, str(idx), chunk_sec, min_sec,
                               channel=ch))
    return cuts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("-d", "--data-dir", required=True)
    ap.add_argument("-s", "--shar-dir", default="data/shards/noise")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--chunk-sec", type=float, default=10.0)
    ap.add_argument("--min-sec", type=float, default=9.0)
    ap.add_argument("-e", "--extension", default="wav")
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter
    from .shard_speech import collect_wavs

    files = collect_wavs(args.data_dir, args.extension)
    print(f"Collected {len(files)} files from {args.data_dir}")
    run_adapter(
        list(enumerate(files)),
        functools.partial(process_noise_file, fs=args.fs,
                          chunk_sec=args.chunk_sec, min_sec=args.min_sec,
                          mono=args.mono),
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force)


if __name__ == "__main__":
    main()
