"""VCTK corpus -> shar shards with the Voicebank-Demand speaker split.

The port's scripts/data/shard_vctk.py, mirroring the reference's
scripts/data/shard_vctk.py: VCTK lays out per-speaker subdirectories; the
test split is speakers p232 + p257 (the VBD test speakers, reference:
shard_vctk.py:31,109-116), train is everyone else. Per-file processing
matches shard_speech (resample, min-sec filter, custom.rms).

    python -m fastenhancer_tpu_torch.scripts.data.shard_vctk -n vctk-train \
        -d VCTK_WAV_DIR -s SHARD_ROOT --split train [--fs 16000] [-j 8] \
        [-f]
"""
import argparse
import functools
import os

TEST_SPEAKERS = {"p232", "p257"}


def collect_split(data_dir: str, split: str, extension: str = "wav"):
    from .shard_speech import collect_wavs

    files = []
    speakers = []
    for entry in sorted(os.listdir(data_dir)):
        spk_dir = os.path.join(data_dir, entry)
        if not os.path.isdir(spk_dir):
            continue
        is_test = entry in TEST_SPEAKERS
        if (split == "test") != is_test:
            continue
        speakers.append(entry)
        files.extend(collect_wavs(spk_dir, extension))
    return files, speakers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("-d", "--data-dir", required=True,
                    help="VCTK dir with per-speaker subdirectories")
    ap.add_argument("-s", "--shar-dir", default="data/shards/speech")
    ap.add_argument("--split", choices=["train", "test"], default="train")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--min-sec", type=float, default=0.5)
    ap.add_argument("-e", "--extension", default="wav")
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter
    from .shard_speech import process_speech_file

    files, speakers = collect_split(args.data_dir, args.split, args.extension)
    print(f"Found {len(files)} files from {len(speakers)} speakers "
          f"(split={args.split}): {', '.join(speakers[:8])}"
          f"{'...' if len(speakers) > 8 else ''}")
    run_adapter(
        list(enumerate(files)),
        functools.partial(process_speech_file, fs=args.fs,
                          min_sec=args.min_sec),
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force)


if __name__ == "__main__":
    main()
