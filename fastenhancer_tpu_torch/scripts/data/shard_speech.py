"""Speech corpus -> shar shards (DNS clean, EARS, HiFiTTS, Expresso, ...).

The port's scripts/data/shard_speech.py, over shar_writer.py, mirroring
the reference's scripts/data/shard_speech.py (:68-89, :216-258): walk a
directory of speech wavs, resample to --fs, skip files shorter than
--min-sec or with zero active RMS, and store each file as one cut with
`custom.rms` = active-segment RMS (the shard mixer's dBFS normalization
reads it).

    python -m fastenhancer_tpu_torch.scripts.data.shard_speech -n dns -d \
        WAV_DIR -s SHARD_ROOT [--fs 16000] [--min-sec 0.5] [-j 8] [-f]
"""
import argparse
import functools
import os

import numpy as np


def process_speech_file(job, fs: int, min_sec: float):
    """(idx, path) -> [cut] | skip-message. Module-level for pool pickling."""
    idx, path = job
    from ...data.audio_io import read_audio
    from ..audiolib import active_rms_relative

    try:
        audio, _ = read_audio(path, sr=fs)
    except Exception as e:  # match reference behavior: report and continue
        return f"Error processing {path}: {e}"
    if len(audio) / fs < min_sec:
        return f"File {path} is too short ({len(audio) / fs:.2f}s), skipping."
    rms = active_rms_relative(audio, fs)
    if rms == 0.0:
        return f"File {path} has zero active RMS, skipping."
    return [{"id": str(idx), "audio": np.asarray(audio, np.float32),
             "sr": fs, "custom": {"rms": float(rms)}}]


def collect_wavs(data_dir: str, extension: str = "wav"):
    out = []
    for dirpath, _, names in os.walk(data_dir, followlinks=True):
        for n in sorted(names):
            if n.endswith(f".{extension}"):
                out.append(os.path.join(dirpath, n))
    out.sort()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("-d", "--data-dir", required=True)
    ap.add_argument("-s", "--shar-dir", default="data/shards/speech")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--min-sec", type=float, default=0.5)
    ap.add_argument("-e", "--extension", default="wav")
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter

    files = collect_wavs(args.data_dir, args.extension)
    print(f"Collected {len(files)} files from {args.data_dir}")
    run_adapter(
        list(enumerate(files)),
        functools.partial(process_speech_file, fs=args.fs,
                          min_sec=args.min_sec),
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force)


if __name__ == "__main__":
    main()
