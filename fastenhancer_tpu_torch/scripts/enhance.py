"""Batch enhancement: a directory of wavs -> enhanced wavs.

    python -m fastenhancer_tpu_torch.scripts.enhance -n NAME [--epoch E] \
        -i IN_DIR -o OUT_DIR [--batch-size 8] [--base_dir logs] \
        [--device cuda]

Counterpart of the repo's scripts/enhance.py: loads a trained run by name,
enhances every wav in IN_DIR through the offline graph (float32; each GRU
of the families that have one on the GRU-scan kernel), writes each result
cut to its input's length, and prints the real-time factor.
"""
import argparse
import os
import time
import typing as tp

import numpy as np
import torch

from . import add_run_args, load_run
from ..utils.precision import full_float32


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    full_float32()
    ap = argparse.ArgumentParser(
        prog="python -m fastenhancer_tpu_torch.scripts.enhance")
    add_run_args(ap)
    ap.add_argument("-i", "--input-dir", required=True)
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    args = ap.parse_args(argv)

    from ..data import read_wav, write_wav
    from ..data.loader import collate

    hps, wrapper = load_run(args.name, args.base_dir, args.epoch,
                            args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.endswith(".wav"))
    sr = hps.data.sampling_rate
    hop = wrapper.hop_size
    t0 = time.perf_counter()
    total_sec = 0.0
    for i in range(0, len(files), args.batch_size):
        chunk = files[i: i + args.batch_size]
        items = []
        for f in chunk:
            wav, _ = read_wav(os.path.join(args.input_dir, f), sr=sr)
            items.append({"noisy": wav.astype(np.float32),
                          "wav_len": len(wav)})
        batch = collate(items, pad_multiple=hop)
        out = wrapper.infer_fn(
            wrapper.state["variables"],
            torch.from_numpy(batch["noisy"]).to(wrapper.device)
        ).cpu().numpy()
        for j, f in enumerate(chunk):
            n = int(batch["wav_len"][j])
            write_wav(os.path.join(args.output_dir, f), out[j, :n], sr)
            total_sec += n / sr
        print(f"\r{min(i + args.batch_size, len(files))}/{len(files)}",
              end="", flush=True)
    wall = time.perf_counter() - t0
    print(f"\nenhanced {len(files)} files "
          f"({total_sec:.1f}s audio) in {wall:.1f}s "
          f"(RTF {wall / max(total_sec, 1e-9):.4f})")


if __name__ == "__main__":
    main()
