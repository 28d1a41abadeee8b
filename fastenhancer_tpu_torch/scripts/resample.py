"""Parallel dataset resampling with a peak guard.

The port's scripts/resample.py (reference: scripts/resample.py:12-31):
resample every wav under --input-dir to --sr with `data/audio_io.py`'s
reader and writer, rescaling when the polyphase filter overshoots past
full scale.

    python -m fastenhancer_tpu_torch.scripts.resample -i IN_DIR -o OUT_DIR \
        --sr 16000 [-j 8]
"""
import argparse
import multiprocessing
import os
import typing as tp
from concurrent.futures import ProcessPoolExecutor


def _one(job):
    src, dst, sr = job
    import numpy as np

    from ..data.audio_io import read_wav, write_wav

    x, _ = read_wav(src, sr=sr)
    peak = np.abs(x).max()
    if peak > 0.999:  # peak guard (reference: scripts/resample.py:22-27)
        x = x * (0.999 / peak)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    write_wav(dst, x, sr)
    return dst


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input-dir", required=True)
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("-j", "--jobs", type=int, default=os.cpu_count())
    args = ap.parse_args(argv)

    jobs = []
    for dirpath, _, files in os.walk(args.input_dir):
        for f in files:
            if f.endswith((".wav", ".WAV")):
                src = os.path.join(dirpath, f)
                rel = os.path.relpath(src, args.input_dir)
                jobs.append((src, os.path.join(args.output_dir, rel), args.sr))
    # spawned workers: a fork of a process that has imported torch may
    # copy a lock another thread holds
    with ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        for i, _ in enumerate(pool.map(_one, jobs), 1):
            print(f"\r{i}/{len(jobs)}", end="", flush=True)
    print(f"\nresampled {len(jobs)} files to {args.sr} Hz")


if __name__ == "__main__":
    main()
