"""Segment DAPS produced recordings with energy VAD.

The port's scripts/data/segment_daps.py, mirroring the reference's
scripts/data/segment_daps.py: flat directory of long studio wavs ->
utterance chunks (min/max-dur cut at the first silence frame, -40
dB-of-peak threshold, padded ends, short tails dropped), PCM16 output,
flat output directory.

    python -m fastenhancer_tpu_torch.scripts.data.segment_daps --src-dir \
        daps/produced --out-dir daps/produced_segmented [--min-dur 3 \
        --max-dur 10]
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
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    from .segment_vad import run_segmenter

    files = sorted(glob.glob(os.path.join(args.src_dir, "*.wav")))
    run_segmenter(files, args.src_dir, args.out_dir,
                  num_workers=args.num_workers, preserve_dirs=False,
                  subtype="pcm16", dry_run=args.dry_run,
                  min_dur=args.min_dur, max_dur=args.max_dur,
                  hop_ms=args.hop_ms, tail_min=args.tail_min,
                  pad_ms=args.pad_ms)


if __name__ == "__main__":
    main()
