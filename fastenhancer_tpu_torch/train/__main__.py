"""Training entry point on one device.

    python -m fastenhancer_tpu_torch.train -n NAME -c configs/<recipe>.yaml \
        [-p a.b=v ...] [-f] [--base_dir logs] [--device cuda]

The counterpart of the repo's `train.py` for one card, for every family:
the VoiceBank recipes (configs/fastenhancer/*.yaml, configs/ablation/,
configs/others/: paired wavs, the `pesq` loss among their losses), the
on-the-fly DNS and 48 kHz recipes (configs/fastenhancer_dns/,
configs/others_dns/, configs/fastenhancer_48khz/: clean and noise files
drawn per item, mixed on the device) and the shard recipes
(configs/fastenhancer_shard/); the same flags
(`-n`, `-c`, `-p`, `-f`, `--base_dir`) and the same epoch loop, plus
`--device` (the card unless named; `--device cpu` runs the plain PyTorch
versions of the kernels, as the CPU tests do). It reads the config without
pyyaml (`utils/hparams.py`), writes it to `{base_dir}/{name}/config.yaml`,
builds the train loader (the shard reader, the on-the-fly dataset, or
paired wavs) and the paired-wav valid and PESQ loaders, and then runs each
epoch: `train_epoch`, valid losses, PESQ/STOI every `pesq.interval`
epochs, and a checkpoint every `train.save_interval` epochs, on the last
and in `test` mode. Run again with the same `-n` (and no `-c`) to resume from the newest
checkpoint.

Not ported: TensorBoard summaries with the showcase `infer_epoch` (ROADMAP
queue 1, "Training, end to end on one card") and the multi-host flags
(queue 1, "Several cards"); each epoch's results are printed and returned.
"""
from __future__ import annotations

import argparse
import os
import random
import time
import typing as tp

import numpy as np
import torch

from .. import require_cuda
from ..data import get_dataset_dataloader
from ..utils.hparams import get_hparams
from ..wrappers import get_wrapper


def parse_args(argv: tp.Optional[tp.Sequence[str]] = None
               ) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m fastenhancer_tpu_torch.train")
    p.add_argument("-n", "--name", required=True,
                   help="run name == {base_dir}/{name} directory")
    p.add_argument("-c", "--config", default=None,
                   help="yaml/json config (omit to resume from the run dir)")
    p.add_argument("-p", "--params", nargs="*", default=[],
                   help="dot-path overrides a.b.c=value")
    p.add_argument("-f", "--force_save", action="store_true",
                   help="overwrite an existing saved config")
    p.add_argument("--base_dir", default="logs")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; "
                        "raises when there is none)")
    return p.parse_args(argv)


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.List[tp.Dict[str, tp.Any]]:
    """Train as the command line says; returns one record per epoch run:
    {"epoch", "train" (scalars), "valid" (scalars, PESQ/STOI included
    where computed), "seconds" (the epoch's wall), "timing" (the wrapper's
    load / step / valid / metrics wall split)}."""
    args = parse_args(argv)
    device = (require_cuda() if args.device is None
              else torch.device(args.device))
    base_dir = os.path.join(args.base_dir, args.name)
    hps = get_hparams(args.config, base_dir, save=True, params=args.params,
                      force_save=args.force_save)
    print("TensorBoard summaries with the showcase infer_epoch (ROADMAP "
          'queue 1, "Training, end to end on one card") and several hosts '
          '("Several cards") are not ported yet: each epoch is printed, and '
          "checkpointed at save_interval")

    seed = getattr(hps.train, "seed", 1)
    random.seed(seed)
    np.random.seed(seed)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    wrapper = get_wrapper(hps.wrapper)(hps, train=True, device=device)
    wrapper.load()  # resume if a checkpoint exists

    train_dataset, train_loader = get_dataset_dataloader(
        hps, "train", wrapper.keys)
    _, valid_loader = get_dataset_dataloader(
        hps, "valid", getattr(wrapper, "val_keys", wrapper.keys))

    save_interval = getattr(hps.train, "save_interval", 20)
    pesq_interval = wrapper.pesq_interval
    max_epochs = hps.train.max_epochs

    history = []
    for epoch in range(wrapper.epoch + 1, max_epochs + 1):
        wrapper.epoch = epoch
        wrapper.timing.clear()
        t0 = time.time()
        if hasattr(train_dataset, "shuffle"):
            train_dataset.shuffle(seed + epoch)

        summary = wrapper.train_epoch(train_loader)
        if "load" in wrapper.timing:
            print(f"epoch {epoch} timing: load {wrapper.timing['load']:.2f}s"
                  f" mix+step {wrapper.timing['step']:.2f}s "
                  f"({wrapper.timing['steps']} steps)")
        # free the shard reader's noise/RIR buffers between epochs
        if hasattr(train_dataset, "release_auxiliary"):
            train_dataset.release_auxiliary()
        summary["scalars"]["lr"] = wrapper.get_lr()

        calc_metrics = bool(pesq_interval and epoch % pesq_interval == 0)
        summary_v = wrapper.valid_epoch(valid_loader,
                                        calculate_metrics=calc_metrics)

        if (epoch % save_interval == 0 or epoch == max_epochs
                or wrapper.test):
            wrapper.save(epoch)

        seconds = time.time() - t0
        msg = "  ".join(f"{k.split('/')[-1]} {v:.4f}"
                        for k, v in summary_v["scalars"].items())
        extra = (wrapper.metrics.print()
                 if (wrapper.metrics and calc_metrics) else "")
        print(f"Epoch {epoch}/{max_epochs}  valid: {msg}{extra}"
              f"  [{seconds:.1f}s]")
        history.append({"epoch": epoch, "train": summary["scalars"],
                        "valid": summary_v["scalars"], "seconds": seconds,
                        "timing": dict(wrapper.timing)})
        if wrapper.test:
            break
    return history


if __name__ == "__main__":
    main()
