"""BRUDEX multichannel RIRs -> shar shards (one cut per channel).

The port's scripts/data/shard_brudex.py, mirroring the reference's
scripts/data/shard_brudex.py (:27-88): the corpus stores RIR wavs under
rev_low/ rev_medium/ rev_high/ with known per-room T60s (310/510/1300 ms —
the reference records them in milliseconds here, unlike gen_brudex_csv
which uses seconds); every channel of every wav becomes one cut with
custom {onset_sample, t60, is_real=True} and id
"{subdir}_{stem}_ch{NN}_{file_idx}".

    python -m fastenhancer_tpu_torch.scripts.data.shard_brudex -n brudex \
        -b BRUDEX_RIR_DIR -s SHARD_ROOT [--fs 16000] [-j 8] [-f]
"""
import argparse
import functools
import glob
import os

import numpy as np

T60_MS = {
    "rev_low": 310.0,
    "rev_medium": 510.0,
    "rev_high": 1300.0,
}


def process_rir_file(job, fs: int):
    file_idx, wav_path, t60_ms = job
    from ...data.audio_io import read_wav
    from ..audiolib import get_rir_start_sample

    try:
        rirs, rir_fs = read_wav(wav_path, mono=False)
    except Exception as e:
        return f"Error processing {wav_path}: {e}"
    if rir_fs != fs:
        return (f"Expected sampling rate {fs}, got {rir_fs} for {wav_path} "
                "(run fastenhancer_tpu_torch.scripts.data.preprocess_brudex "
                "first)")
    if rirs.ndim == 1:
        rirs = rirs[None, :]
    stem = (os.path.basename(os.path.dirname(wav_path)) + "_"
            + os.path.splitext(os.path.basename(wav_path))[0])
    cuts = []
    for ch_idx, rir in enumerate(rirs):
        cuts.append({
            "id": f"{stem}_ch{ch_idx:02d}_{file_idx}",
            "audio": np.asarray(rir, np.float32), "sr": rir_fs,
            # stored in SECONDS: the shard consumer (data/shard.py
            # _pick_rir -> shard_mixer.get_rts_rir) interprets custom
            # ["t60"] in seconds, like shard_myriad writes. The reference
            # adapter writes milliseconds here (scripts/data/
            # shard_brudex.py:72) even though its get_rts_rir documents
            # seconds; the consumer (shard.py _pick_rir) normalizes
            # implausibly-large values as ms so reference-built shards
            # still load correctly.
            "custom": {"onset_sample": int(get_rir_start_sample(rir)),
                       "t60": t60_ms / 1000.0, "is_real": True}})
    return cuts


def build_file_entries(base_dir: str):
    entries = []
    file_idx = 0
    for subdir_name, t60_ms in T60_MS.items():
        for wav_path in sorted(glob.glob(
                os.path.join(base_dir, subdir_name, "*.wav"))):
            entries.append((file_idx, wav_path, t60_ms))
            file_idx += 1
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-n", "--name", default="brudex")
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
