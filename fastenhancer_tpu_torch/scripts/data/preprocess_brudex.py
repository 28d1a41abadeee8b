"""BRUDEX raw MAT RIRs -> peak-normalized, resampled wav files.

The port's scripts/data/preprocess_brudex.py (reference: scripts/data/
preprocess_brudex.py:14-47): each .mat file holds `data` [samples,
channels] and `fs`; the RIR bank is resampled to --to-sr,
peak-normalized to 0.99, and written as multichannel wav mirroring the
source tree. MATLAB v7.3 files are read via h5py (the reference uses
mat73; both are HDF5 readers), imported only for such a file: without
h5py a v7.3 file stops the run with an ImportError naming it, never a
skipped file. Older MAT files go through scipy.io. Resampling is the
library's polyphase kernel (data/audio_io.py) instead of torchaudio's
windowed sinc — same quality class as the reference's
lowpass_filter_width=512 settings. The pool is spawned.

    python -m fastenhancer_tpu_torch.scripts.data.preprocess_brudex \
        --from-dir brudex/rir --to-dir brudex/rir_16khz [--to-sr 16000]
"""
import argparse
import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def load_mat_rir(path: str):
    """-> (data [samples, channels] float32, fs). Handles MAT v7.3 (HDF5)
    and earlier versions."""
    with open(path, "rb") as fh:
        head = fh.read(128)
    if b"MATLAB 7.3" in head or head[:4] == b"\x89HDF":
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{path} is a MATLAB v7.3 (HDF5) file: reading it needs "
                "the h5py package, which is not installed") from e

        with h5py.File(path, "r") as f:
            # MATLAB stores column-major: a [samples, channels] array
            # appears transposed through h5py
            data = np.asarray(f["data"]).T
            fs = np.asarray(f["fs"])
    else:
        from scipy.io import loadmat

        mat = loadmat(path)
        data, fs = mat["data"], mat["fs"]
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if data.shape[0] < data.shape[1]:  # orient time along axis 0
        data = data.T
    return data, int(np.asarray(fs).reshape(-1)[0])


def resample_rir(job, from_dir: str, to_dir: str, sr: int) -> int:
    from_file = job
    from ...data.audio_io import resample, write_wav

    try:
        data, orig_sr = load_mat_rir(os.path.join(from_dir, from_file))
        wav = data.T  # [C, T]: resample along the last (time) axis
        if orig_sr != sr:
            wav = resample(wav, orig_sr, sr)
        peak = np.abs(wav).max()
        if peak > 1e-8:
            wav = wav / peak * 0.99
        to_file = os.path.join(
            to_dir, os.path.splitext(from_file)[0] + ".wav")
        os.makedirs(os.path.dirname(to_file), exist_ok=True)
        write_wav(to_file, wav.T.astype(np.float32), sr)
        return wav.shape[1]
    except ImportError:
        raise
    except Exception as e:
        print(f"Error processing {from_file}: {e}")
        return -1


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--to-sr", type=int, default=16_000)
    ap.add_argument("--from-dir", required=True)
    ap.add_argument("--to-dir", required=True)
    ap.add_argument("--num-workers", type=int, default=4)
    args = ap.parse_args(argv)

    filelists = []
    for root, _, files in os.walk(args.from_dir):
        for f in sorted(files):
            if f.endswith(".mat"):
                filelists.append(os.path.relpath(
                    os.path.join(root, f), args.from_dir))
    filelists.sort()
    print(f"Total files: {len(filelists)}")

    work = functools.partial(resample_rir, from_dir=args.from_dir,
                             to_dir=args.to_dir, sr=args.to_sr)
    if args.num_workers > 1:
        with ProcessPoolExecutor(
                args.num_workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(work, filelists))
    else:
        results = [work(f) for f in filelists]
    total = sum(r for r in results if r > 0) / args.to_sr
    h, rem = divmod(int(total), 3600)
    print(f"Done. Total audio: {h}:{rem // 60:02d}:{rem % 60:02d}")


if __name__ == "__main__":
    main()
