"""Shard builder: directory of wavs -> lhotse-shar-compatible shard dir.

The port's scripts/data/shard_wavdir.py, an analog of the reference's
scripts/data/shard_{speech,noise,vctk,...}.py family (which use lhotse's
SharWriter with flac fields): writes `cuts.NNNNNN.jsonl.gz` +
`recording.NNNNNN.tar` pairs readable by data/shard.py's ShardSource.
Audio is stored as wav (no flac encoder is used; the reader accepts flac
when soundfile is installed).

    python -m fastenhancer_tpu_torch.scripts.data.shard_wavdir -i WAV_DIR \
        -o SHARD_DIR [--sr 16000] [--shard-size 1000] \
        [--kind speech|noise|rir] \
        [--segment]   # VAD-split long recordings into utterance cuts
"""
import argparse
import gzip
import io
import json
import os
import tarfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input-dir", required=True)
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--shard-size", type=int, default=1000)
    ap.add_argument("--kind", default="speech",
                    choices=["speech", "noise", "rir"],
                    help="rir shards get onset/t60 metadata "
                         "(reference: scripts/data/shard_dns_rir.py)")
    ap.add_argument("--segment", action="store_true",
                    help="energy-VAD split each file into utterance cuts "
                         "(reference: scripts/data/segment_daps.py)")
    ap.add_argument("--min-speech-sec", type=float, default=0.5)
    args = ap.parse_args(argv)

    from ...data.audio_io import read_wav
    from .shar_writer import wav_bytes
    from ..audiolib import (estimate_t60, find_rir_onset_spectral,
                            vad_segments)

    files = []
    for dirpath, _, names in os.walk(args.input_dir):
        for n in sorted(names):
            if n.endswith((".wav", ".WAV")):
                files.append(os.path.join(dirpath, n))
    files.sort()
    os.makedirs(args.output_dir, exist_ok=True)

    shard_idx = 0
    written = 0
    tar = None
    metas = []

    def flush():
        nonlocal tar, metas, shard_idx
        if tar is None:
            return
        tar.close()
        with gzip.open(os.path.join(
                args.output_dir, f"cuts.{shard_idx:06d}.jsonl.gz"), "wt") as f:
            for m in metas:
                f.write(json.dumps(m) + "\n")
        shard_idx += 1
        tar = None
        metas = []

    for path in files:
        if tar is None:
            tar = tarfile.open(os.path.join(
                args.output_dir, f"recording.{shard_idx:06d}.tar"), "w")
        x, _ = read_wav(path, sr=args.sr)
        base = os.path.splitext(os.path.relpath(path, args.input_dir)
                                )[0].replace(os.sep, "_")
        if args.segment:
            spans = vad_segments(x, args.sr,
                                 min_speech_sec=args.min_speech_sec)
            pieces = [(f"{base}_{k:03d}", x[s:e])
                      for k, (s, e) in enumerate(spans)]
        else:
            pieces = [(base, x)]
        for cid, xs in pieces:
            if tar is None:
                tar = tarfile.open(os.path.join(
                    args.output_dir, f"recording.{shard_idx:06d}.tar"), "w")
            meta = {"id": cid, "duration": len(xs) / args.sr}
            if args.kind == "rir":
                meta["custom"] = {
                    "rir_onset": int(find_rir_onset_spectral(xs, args.sr)),
                    "t60": float(estimate_t60(xs, args.sr)),
                }
            data = wav_bytes(xs, args.sr)
            info = tarfile.TarInfo(f"{cid}.wav")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            metas.append(meta)
            written += 1
            if written % args.shard_size == 0:
                flush()
        if written % 100 == 0:
            print(f"\r{written}/{len(files)}", end="", flush=True)
    flush()
    print(f"\nwrote {written} cuts across {shard_idx} shards "
          f"-> {args.output_dir}")


if __name__ == "__main__":
    main()
