"""DNS-Challenge RIR metadata CSV -> shar shards with onset/T60 custom fields.

The port's scripts/data/shard_dns_rir.py, mirroring the reference's
scripts/data/shard_dns_rir.py (:52-78): each CSV line is
`path,channel,t60,c50,is_real`; the RIR is loaded from --base-dir/path
(Windows separators in the CSV are normalized), channel is 1-indexed, the
onset sample comes from the -20 dB-to-peak heuristic with a spectral-flux
cross-check warning, and the cut carries custom {onset_sample, t60, c50,
is_real} — the shard mixer's dereverberation target synthesis reads these
(data/shard.py:_pick_rir, shard_mixer rts/early_rir).

    python -m fastenhancer_tpu_torch.scripts.data.shard_dns_rir -n dns-rir \
        --csv rir_table.csv -d RIR_BASE_DIR -s SHARD_ROOT [--fs 16000] [-j \
        8] [-f]
"""
import argparse
import functools
import os
from pathlib import PureWindowsPath

import numpy as np


def process_rir_line(job, base_dir: str, fs: int):
    idx, line = job
    from ...data.audio_io import read_wav
    from ..audiolib import find_rir_onset_spectral, get_rir_start_sample

    try:
        path, ch, t60, c50, is_real = line.strip().split(",")
        ch = int(ch)
        full = os.path.join(base_dir, PureWindowsPath(path).as_posix())
        rir, rir_fs = read_wav(full, mono=False)
        if rir.ndim > 1:
            rir = rir[ch - 1]
        elif ch != 1:
            return (f"File {full} is mono but channel {ch} was requested.")
        if rir_fs != fs:
            return (f"Expected sampling rate {fs}, got {rir_fs} for {full}")
    except Exception as e:
        return f"Error processing line {idx} ({line.strip()[:60]}): {e}"
    onset_heuristic = int(get_rir_start_sample(rir))
    onset_spectral = int(find_rir_onset_spectral(rir, rir_fs))
    if abs(onset_spectral - onset_heuristic) > 0.001 * fs:
        print(f"Onset mismatch for {full}: "
              f"spectral={onset_spectral} vs heuristic={onset_heuristic}")
    return [{"id": str(idx), "audio": np.asarray(rir, np.float32),
             "sr": rir_fs,
             "custom": {"onset_sample": onset_heuristic,
                        "t60": float(t60), "c50": float(c50),
                        "is_real": bool(int(is_real))}}]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("--csv", required=True,
                    help="CSV of path,channel,t60,c50,is_real lines")
    ap.add_argument("-d", "--base-dir", required=True)
    ap.add_argument("-s", "--shar-dir", default="data/shards/rir")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter

    with open(args.csv) as f:
        lines = [ln for ln in f if ln.strip()]
    if lines and lines[0].lower().startswith("path"):
        lines = lines[1:]  # header row
    print(f"Read {len(lines)} RIR entries from {args.csv}")
    run_adapter(
        list(enumerate(lines)),
        functools.partial(process_rir_line, base_dir=args.base_dir,
                          fs=args.fs),
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force)


if __name__ == "__main__":
    main()
