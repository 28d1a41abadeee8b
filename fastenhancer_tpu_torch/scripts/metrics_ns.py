"""Offline evaluation over a paired test set.

    python -m fastenhancer_tpu_torch.scripts.metrics_ns -n NAME [--epoch E] \
        [-p a.b=v ...] [--max-items N] [--wer] [--no-external] \
        [--base_dir logs] [--device cuda]

Counterpart of the repo's scripts/metrics_ns.py: enhances the config's
`pesq` set (float32 offline graph) and prints SISDR, STOI, ESTOI and PESQ
(wideband P.862, the signals resampled to 16 kHz) as means over the files.
The external-model scores are not ported (their packages, torchmetrics,
onnxruntime, whisper and jiwer, are not installed): DNSMOS and SCOREQ print
one "skipped" line each unless `--no-external`, and `--wer` raises.
"""
import argparse
import typing as tp

import numpy as np

from . import add_run_args, load_run
from ..utils.precision import full_float32


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.Dict[str, float]:
    """Prints the scores; returns them ({"sisdr", "stoi", "estoi", "pesq"},
    means over the scored files)."""
    full_float32()
    ap = argparse.ArgumentParser(
        prog="python -m fastenhancer_tpu_torch.scripts.metrics_ns")
    add_run_args(ap)
    ap.add_argument("-p", "--params", nargs="*", default=[])
    ap.add_argument("--max-items", type=int, default=None)
    ap.add_argument("--wer", action="store_true",
                    help="score Whisper WER (not ported: raises)")
    ap.add_argument("--no-external", action="store_true",
                    help="skip the DNSMOS/SCOREQ lines")
    args = ap.parse_args(argv)
    if args.wer:
        raise ImportError(
            "WER needs openai-whisper + jiwer (the external-model metrics "
            "are not ported)")

    from ..data import get_dataset_dataloader
    from ..metrics import estoi, pesq_provider, pesq_wb, sisdr, stoi

    hps, wrapper = load_run(args.name, args.base_dir, args.epoch,
                            args.device, params=args.params)
    _, loader = get_dataset_dataloader(hps, "pesq",
                                       ["clean", "noisy", "wav_len"])
    sr = hps.data.sampling_rate
    if pesq_provider() != "pesq-lib":
        print("[metrics] PESQ via the native P.862 implementation "
              "(install `pesq` for certified scores)")
    if not args.no_external:
        print("[metrics] DNSMOS skipped: DNSMOS needs torchmetrics[audio] + "
              "onnxruntime (absent in this environment, and the ONNX models "
              "need network access)")
        print("[metrics] SCOREQ skipped: SCOREQ needs onnxruntime (absent in "
              "this environment)")

    sums = {"sisdr": 0.0, "stoi": 0.0, "estoi": 0.0, "pesq": 0.0}
    n = n_pesq = 0
    for batch in loader:
        dev_batch, rows = wrapper._device_batch(batch, ("clean", "noisy"))
        wav_hat = wrapper.infer_fn(wrapper.state["variables"],
                                   dev_batch["noisy"]).cpu().numpy()
        clean = dev_batch["clean"].cpu().numpy()
        for i in range(rows):
            ln = min(int(batch["wav_len"][i]), wav_hat.shape[-1])
            c, e = clean[i, :ln], wav_hat[i, :ln]
            sums["sisdr"] += sisdr(e, c)
            sums["stoi"] += stoi(c, e, sr)
            sums["estoi"] += estoi(c, e, sr)
            try:
                sums["pesq"] += pesq_wb(c, e, sr)
                n_pesq += 1
            except Exception:
                # PESQ rejects degenerate items (too short, silent): score
                # the rest instead of stopping
                pass
            n += 1
            print(f"\rscored {n}", end="", flush=True)
        if args.max_items and n >= args.max_items:
            break
    print()
    means = {k: v / max(n, 1) for k, v in sums.items() if k != "pesq"}
    for k, v in means.items():
        print(f"{k.upper():>6}: {v:.4f}")
    if n_pesq:
        means["pesq"] = sums["pesq"] / n_pesq
        print(f"{'PESQ':>6}: {means['pesq']:.4f}"
              + (f"  ({n - n_pesq} unscorable)" if n_pesq < n else ""))
    return means


if __name__ == "__main__":
    main()
