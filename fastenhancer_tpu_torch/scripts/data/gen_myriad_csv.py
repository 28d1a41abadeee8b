"""Generate the MYRiAD RIR CSV (path,channel,t60) for ReverbDataset.

The port's scripts/data/gen_myriad_csv.py, mirroring the reference's
scripts/data/gen_myriad_csv.py: one row per wav under SAL/ (T60 2.1 s) and
AIL/ (0.5 s), recursive, channel fixed to 1.

    python -m fastenhancer_tpu_torch.scripts.data.gen_myriad_csv \
        --base-dir MYRIAD_16K_DIR -o out.csv
"""
import argparse
import csv
import glob
import os

T60_S = {
    "SAL": 2.1,
    "AIL": 0.5,
}


def iter_entries(base_dir: str):
    for subdir_name, t60 in T60_S.items():
        for wav_path in sorted(glob.glob(
                os.path.join(base_dir, subdir_name, "**", "*.wav"),
                recursive=True)):
            yield os.path.relpath(wav_path, base_dir), 1, t60


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
