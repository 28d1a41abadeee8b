"""Generate the BRUDEX RIR CSV (path,channel,t60) for ReverbDataset.

The port's scripts/data/gen_brudex_csv.py, mirroring the reference's
scripts/data/gen_brudex_csv.py: one row per channel of every wav under
rev_low/ rev_medium/ rev_high/, T60 in seconds (0.31/0.51/1.3 — unlike
shard_brudex, which stores milliseconds). The CSV feeds
scripts/data/shard_test.py's nearend-RIR sampler and
scripts/data/shard_dns_rir.py-style CSV loaders.

    python -m fastenhancer_tpu_torch.scripts.data.gen_brudex_csv \
        --base-dir BRUDEX_RIR_DIR -o out.csv
"""
import argparse
import csv
import glob
import os
import struct

T60_S = {
    "rev_low": 0.31,
    "rev_medium": 0.51,
    "rev_high": 1.3,
}


def wav_channels(path: str) -> int:
    """Channel count from the RIFF fmt chunk (no full decode; works for
    PCM and IEEE-float wavs, unlike stdlib wave)."""
    with open(path, "rb") as f:
        if f.read(12)[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"no fmt chunk in {path}")
            cid, size = struct.unpack("<4sI", head)
            if cid == b"fmt ":
                return struct.unpack("<H", f.read(4)[2:4])[0]
            f.seek(size + (size & 1), 1)


def iter_entries(base_dir: str):
    for subdir_name, t60 in T60_S.items():
        for wav_path in sorted(glob.glob(
                os.path.join(base_dir, subdir_name, "*.wav"))):
            rel = os.path.relpath(wav_path, base_dir)
            for ch in range(1, wav_channels(wav_path) + 1):
                yield rel, ch, t60


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--base-dir", required=True)
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    rows = list(iter_entries(args.base_dir))
    print(f"Total entries: {len(rows)}")
    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "channel", "t60"])
        w.writerows(rows)
    print(f"Saved to {args.output}")


if __name__ == "__main__":
    main()
