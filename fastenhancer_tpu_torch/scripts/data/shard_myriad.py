"""MYRiAD v2 RIRs -> shar shards (mono downmix, per-room T60).

The port's scripts/data/shard_myriad.py, mirroring the reference's
scripts/data/shard_myriad.py (:20-60): wavs under SAL/ (T60 2.1 s) and
AIL/ (0.5 s) are globbed recursively and sorted globally; each file
becomes one mono cut with custom {onset_sample, t60, is_real=True} and id
"{grandparent}_{parent}_{stem}_{idx}".

    python -m fastenhancer_tpu_torch.scripts.data.shard_myriad -n myriad \
        -b MYRIAD_16K_DIR -s SHARD_ROOT [--fs 16000] [-j 8] [-f]
"""
import argparse
import functools
import glob
import os

import numpy as np

T60_S = {
    "SAL": 2.1,
    "AIL": 0.5,
}


def process_rir_file(job, fs: int):
    idx, wav_path, t60_s = job
    from ...data.audio_io import read_wav
    from ..audiolib import get_rir_start_sample

    try:
        rir, rir_fs = read_wav(wav_path)  # mono downmix like the reference
    except Exception as e:
        return f"Error processing {wav_path}: {e}"
    if rir_fs != fs:
        return f"Expected sampling rate {fs}, got {rir_fs} for {wav_path}"
    parts = os.path.normpath(wav_path).split(os.sep)
    stem = os.path.splitext(parts[-1])[0]
    cut_id = f"{parts[-3]}_{parts[-2]}_{stem}_{idx}"
    return [{"id": cut_id, "audio": np.asarray(rir, np.float32),
             "sr": rir_fs,
             "custom": {"onset_sample": int(get_rir_start_sample(rir)),
                        "t60": t60_s, "is_real": True}}]


def build_file_entries(base_dir: str):
    wavs = sorted(
        w for subdir in T60_S
        for w in glob.glob(os.path.join(base_dir, subdir, "**", "*.wav"),
                           recursive=True))
    entries = []
    for idx, wav_path in enumerate(wavs):
        room = os.path.relpath(wav_path, base_dir).split(os.sep)[0]
        entries.append((idx, wav_path, T60_S[room]))
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-n", "--name", default="myriad")
    ap.add_argument("-b", "--base-dir", required=True)
    ap.add_argument("-s", "--shar-dir", default="data/shards/rir")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter

    entries = build_file_entries(args.base_dir)
    print(f"Total files: {len(entries)}")
    run_adapter(entries, functools.partial(process_rir_file, fs=args.fs),
                args.shar_dir, args.name, shard_size=args.shard_size,
                num_jobs=args.num_jobs, force=args.force)


if __name__ == "__main__":
    main()
