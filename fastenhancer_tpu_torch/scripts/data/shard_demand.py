"""DEMAND noise corpus -> shar shards with the scene-based train/test split.

The port's scripts/data/shard_demand.py, mirroring the reference's
scripts/data/shard_demand.py: DEMAND lays out per-scene directories
(optionally suffixed, e.g. DKITCHEN_16k); the train split is the 13 scenes
used by the reference (:32-36), test is the rest. Files are chunked into
--chunk-sec pieces with custom.rms, like shard_noise.

    python -m fastenhancer_tpu_torch.scripts.data.shard_demand -n \
        demand-train -d DEMAND_DIR -s SHARD_ROOT --split train [--fs \
        16000] [-j 8] [-f]
"""
import argparse
import functools
import os

TRAIN_SCENES = {
    "DKITCHEN", "DWASHING", "NFIELD", "NPARK", "NRIVER",
    "OHALLWAY", "OMEETING", "PCAFETER", "PRESTO", "PSTATION",
    "STRAFFIC", "TCAR", "TMETRO",
}


def collect_split(data_dir: str, split: str, extension: str = "wav"):
    from .shard_speech import collect_wavs

    files = []
    scenes = []
    for entry in sorted(os.listdir(data_dir)):
        scene_dir = os.path.join(data_dir, entry)
        if not os.path.isdir(scene_dir):
            continue
        # names may carry a rate suffix like "_16k" (reference :216-217)
        scene = entry.split("_")[0]
        is_train = scene in TRAIN_SCENES
        if (split == "train") != is_train:
            continue
        scenes.append(scene)
        files.extend(collect_wavs(scene_dir, extension))
    return files, scenes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("-d", "--data-dir", required=True,
                    help="DEMAND dir with per-scene subdirectories")
    ap.add_argument("-s", "--shar-dir", default="data/shards/noise")
    ap.add_argument("--split", choices=["train", "test"], default="train")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--chunk-sec", type=float, default=10.0)
    ap.add_argument("--min-sec", type=float, default=9.0)
    ap.add_argument("-e", "--extension", default="wav")
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter
    from .shard_noise import process_noise_file

    files, scenes = collect_split(args.data_dir, args.split, args.extension)
    print(f"Found {len(files)} files from {len(scenes)} scenes "
          f"(split={args.split}): {', '.join(scenes)}")
    run_adapter(
        list(enumerate(files)),
        functools.partial(process_noise_file, fs=args.fs,
                          chunk_sec=args.chunk_sec, min_sec=args.min_sec,
                          mono=True),
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force)


if __name__ == "__main__":
    main()
