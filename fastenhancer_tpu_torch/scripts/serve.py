"""Streaming serving: many wavs through one dynamic-batched engine.

    python -m fastenhancer_tpu_torch.scripts.serve -n NAME -i IN_DIR \
        -o OUT_DIR [--capacity 8] [--stagger 25] [--fused] [--dtype bf16] \
        [--epoch E] [--base_dir logs] [--device cuda]

Counterpart of the repo's scripts/serve.py over the port's
`StreamingEngine`: a fixed-capacity slot pool ticking hop by hop, with
streams joining every `stagger` ticks while a slot is free and leaving as
they finish. `--fused` folds the variables and runs the family's block
stack as one kernel a tick (the FE family's stack kernel, dpt's, BSRNN's or
dprnn's); `--dtype bf16` casts the variables to bfloat16, as the engine
requires. Each stream gets extra silence ticks that flush the n_fft - hop
delay, and its output is trimmed to its input's length. Prints per-tick
wall latency percentiles and the aggregate RTF.
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
        prog="python -m fastenhancer_tpu_torch.scripts.serve")
    add_run_args(ap)
    ap.add_argument("-i", "--input-dir", required=True)
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("--capacity", type=int, default=8,
                    help="slot count = the batch of every step")
    ap.add_argument("--stagger", type=int, default=25,
                    help="ticks between stream admissions (25 = 400 ms at "
                         "16 kHz/hop 256)")
    ap.add_argument("--fused", action="store_true",
                    help="fold the weights and run the block stack kernel")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "bf16"])
    args = ap.parse_args(argv)
    if args.stagger < 1:
        ap.error("--stagger must be >= 1 (ticks between admissions)")

    from ..data import read_wav, write_wav
    from ..serving import StreamingEngine
    from ..utils import cast_floating

    hps, wrapper = load_run(args.name, args.base_dir, args.epoch,
                            args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    model = wrapper.model
    variables = wrapper.state["variables"]
    if args.fused:
        variables = model.fold(variables)
    dtype = (torch.bfloat16 if args.dtype in ("bf16", "bfloat16")
             else torch.float32)
    if dtype != torch.float32:
        # the engine's contract: variables cast to the carry and
        # activation dtype (it refuses a mismatched pair)
        variables = cast_floating(variables, dtype)
    engine = StreamingEngine(model, variables, capacity=args.capacity,
                             dtype=dtype, fused=args.fused,
                             device=wrapper.device)
    sr = hps.data.sampling_rate
    hop = engine.hop

    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.endswith(".wav"))
    if not files:
        raise FileNotFoundError(f"no .wav files in {args.input_dir}")
    pending = list(files)
    # per-stream session state: handle -> [filename, wav, cursor, outputs,
    # length]
    sessions: tp.Dict[int, list] = {}
    tick_wall = []
    total_samples = 0
    tick_idx = 0
    t_start = time.perf_counter()
    while pending or sessions:
        # admit a new stream every `stagger` ticks while slots are free
        if (pending and engine.active < args.capacity
                and tick_idx % args.stagger == 0):
            f = pending.pop(0)
            wav, _ = read_wav(os.path.join(args.input_dir, f), sr=sr)
            wav = wav.astype(np.float32)
            h = engine.open_stream()
            # drain ticks: extra silence hops that flush the n_fft-hop delay
            drain = -(-engine.delay_samples // hop)
            n_ticks = -(-len(wav) // hop) + drain
            sessions[h] = [f, np.pad(wav, (0, n_ticks * hop - len(wav))),
                           0, [], len(wav)]
        if not sessions:
            tick_idx += 1
            continue
        hops = {h: wav[cur * hop:(cur + 1) * hop]
                for h, (_, wav, cur, _, _) in sessions.items()}
        t0 = time.perf_counter()
        outs = engine.tick(hops)
        tick_wall.append(time.perf_counter() - t0)
        done = []
        for h, out in outs.items():
            sess = sessions[h]
            sess[2] += 1
            sess[3].append(out)
            if sess[2] * hop >= len(sess[1]):
                done.append(h)
        for h in done:
            f, wav, _, outs_list, n = sessions.pop(h)
            engine.close_stream(h)
            full = np.concatenate(outs_list)[engine.delay_samples:]
            write_wav(os.path.join(args.output_dir, f), full[:n], sr)
            total_samples += n
            print(f"\rdone {len(files) - len(pending) - len(sessions)}"
                  f"/{len(files)}", end="", flush=True)
        tick_idx += 1
    wall = time.perf_counter() - t_start
    ticks = np.sort(np.array(tick_wall[1:]) * 1e3)  # skip the first tick
    audio_sec = total_samples / sr
    print(f"\nserved {len(files)} streams ({audio_sec:.1f}s audio) "
          f"in {wall:.2f}s — aggregate RTF {wall / max(audio_sec, 1e-9):.5f}")
    if len(ticks):
        print(f"tick latency ms: p50 {ticks[len(ticks) // 2]:.2f} "
              f"p90 {ticks[int(len(ticks) * .9)]:.2f} "
              f"p99 {ticks[min(int(len(ticks) * .99), len(ticks) - 1)]:.2f} "
              f"(hop period {hop / sr * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
