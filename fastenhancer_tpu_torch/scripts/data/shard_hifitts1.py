"""HiFi-TTS speech corpus (flac) -> shar shards.

The port's scripts/data/shard_hifitts1.py, mirroring the reference's
scripts/data/shard_hifitts1.py (:70-90, :178-255): recursive walk for
--extension files (flac by default — decoded via soundfile when installed;
wav needs nothing), mono downmix, polyphase resample to --fs, drop files
shorter than --min-sec or with zero active RMS, one cut per file with
`custom.rms`. The reference batches pool work (--batch-size) purely to
bound writer-queue memory; here the writer consumes the pool iterator
directly so memory stays bounded without batching, and --batch-size is
divided across workers to size the pool chunks (capped at 64 files per
chunk to keep the tail balanced).

    python -m fastenhancer_tpu_torch.scripts.data.shard_hifitts1 -n \
        hifitts -d HIFITTS_AUDIO_DIR -s SHARD_ROOT [--fs 16000] [-e flac] \
        [-j 8] [-f]
"""
import argparse
import functools


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("-d", "--data-dir", required=True)
    ap.add_argument("-s", "--shar-dir", default="data/shards/speech")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--min-sec", type=float, default=0.5)
    ap.add_argument("-e", "--extension", default="flac")
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=1280,
                    help="pool chunk sizing hint (see module docstring)")
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("--shard-size", type=int, default=1000)
    args = ap.parse_args(argv)

    from .shar_writer import run_adapter
    # process_speech_file reads via read_audio, which decodes flac through
    # soundfile and wav natively — shared with the wav-corpus adapter
    from .shard_speech import collect_wavs, process_speech_file

    files = collect_wavs(args.data_dir, extension=args.extension)
    print(f"Total files: {len(files)}")
    run_adapter(
        list(enumerate(files)),
        functools.partial(process_speech_file, fs=args.fs,
                          min_sec=args.min_sec),
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force,
        chunksize=min(64, max(1, args.batch_size // max(args.num_jobs, 1))))


if __name__ == "__main__":
    main()
