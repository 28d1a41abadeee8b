"""Segment EARS recordings with energy VAD (speaker dirs preserved).

The port's scripts/data/segment_ears.py, mirroring the reference's
scripts/data/segment_ears.py: recursive walk of speaker subdirectories, 80
Hz high-pass applied to the VAD signal only (room rumble must not count as
activity; output chunks come from the unfiltered audio), IEEE-float32
output by default (no re-quantization of the studio masters), source
directory structure preserved.

    python -m fastenhancer_tpu_torch.scripts.data.segment_ears --src-dir ears \
        --out-dir ears/segmented [--subtype pcm16]
"""
import argparse
import glob
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--src-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--min-dur", type=float, default=3.0)
    ap.add_argument("--max-dur", type=float, default=10.0)
    ap.add_argument("--hop-ms", type=int, default=100)
    ap.add_argument("--tail-min", type=float, default=1.0)
    ap.add_argument("--pad-ms", type=int, default=200)
    ap.add_argument("--highpass-hz", type=float, default=80.0)
    ap.add_argument("--subtype", default="float32",
                    choices=["float32", "pcm16"])
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    from .segment_vad import run_segmenter

    files = sorted(glob.glob(os.path.join(args.src_dir, "**", "*.wav"),
                             recursive=True))
    run_segmenter(files, args.src_dir, args.out_dir,
                  num_workers=args.num_workers, preserve_dirs=True,
                  subtype=args.subtype, dry_run=args.dry_run,
                  min_dur=args.min_dur, max_dur=args.max_dur,
                  hop_ms=args.hop_ms, tail_min=args.tail_min,
                  pad_ms=args.pad_ms, highpass_hz=args.highpass_hz)


if __name__ == "__main__":
    main()
