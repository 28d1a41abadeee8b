"""Training entry point, on one device or as one rank of several.

    python -m fastenhancer_tpu_torch.train -n NAME -c configs/<recipe>.yaml \
        [-p a.b=v ...] [-f] [--base_dir logs] [--device cuda] \
        [--coordinator HOST:PORT --num_processes W --process_id R]

The counterpart of the repo's `train.py`, for every family:
the VoiceBank recipes (configs/fastenhancer/*.yaml, configs/ablation/,
configs/others/: paired wavs, the `pesq` loss among their losses), the
on-the-fly DNS and 48 kHz recipes (configs/fastenhancer_dns/,
configs/others_dns/, configs/fastenhancer_48khz/: clean and noise files
drawn per item, mixed on the device) and the shard recipes
(configs/fastenhancer_shard/); the same flags
(`-n`, `-c`, `-p`, `-f`, `--base_dir`, and the multi-host
`--coordinator`, `--num_processes`, `--process_id`) and the same epoch
loop, plus `--device` (the card unless named; `--device cpu` runs the
plain PyTorch versions of the kernels, as the CPU tests do). It reads
the config without pyyaml (`utils/hparams.py`), writes it to
`{base_dir}/{name}/config.yaml`, builds the train loader (the shard reader, the on-the-fly dataset, or
paired wavs) and the paired-wav valid and PESQ loaders, and then runs each
epoch: `train_epoch`, valid losses, PESQ/STOI every `pesq.interval`
epochs, the showcase `infer_epoch` every `infer.interval` epochs (its
loader built the first time), and a checkpoint every `train.save_interval`
epochs, on the last and in `test` mode. Each epoch's summaries go to
TensorBoard event files (`utils/event_file.py`), the train ones (losses,
`lr`, with `train.plot_param_and_grad` the parameter and gradient
histograms) under `{base_dir}/{name}/train/`, the valid and showcase ones
(losses, PESQ/STOI, audio, spectrograms, `infer/sisdr`) under `valid/`;
`train.profile` traces a window of train steps into `profile/`. Run again
with the same `-n` (and no `-c`) to resume from the newest checkpoint.
Each epoch's results are also printed and returned.

Several ranks: run the command W times with the same `--coordinator`
(rank 0's host:port) and `--num_processes W`, and `--process_id` 0 to W -
1, one process per card (JAX runs one per host): rank r takes card
`r % device_count` unless `--device` names one, and joins the group over
NCCL on a card, gloo on the CPU (`parallel.init`; a caller that has
joined a group before calling `main` keeps its own). Each rank loads its
own stride of the batches, and W ranks at `train.batch_size` B train as
one process at W * B (`parallel`). Rank 0 alone writes the config, the
event files, the showcase and the checkpoints, and prints; every rank
loads a checkpoint to resume. The group is left at the end.
"""
from __future__ import annotations

import argparse
import os
import random
import time
import typing as tp

import numpy as np
import torch

from .. import parallel, require_cuda
from ..data import get_dataset_dataloader
from ..utils.event_file import EventWriter
from ..utils.hparams import get_hparams
from ..utils.precision import full_float32
from ..utils.summarize import summarize
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
                   help="torch device (default: the first CUDA card, or "
                        "card process_id %% device_count under several "
                        "processes; raises when there is none)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for multi-host training")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.List[tp.Dict[str, tp.Any]]:
    """Train as the command line says; returns one record per epoch run:
    {"epoch", "train" (scalars), "valid" (scalars, PESQ/STOI included
    where computed), "infer" (scalars, where the showcase ran), "seconds"
    (the epoch's wall), "timing" (the wrapper's load / step / valid /
    metrics wall split, with "infer" and "summarize": the showcase's and
    the event files' walls)}."""
    full_float32()
    args = parse_args(argv)
    joined = False
    if args.coordinator:
        # before get_hparams, so that only rank 0 writes the run's config
        device = parallel.init(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
        joined = True
    elif args.device is not None:
        device = torch.device(args.device)
    elif parallel.world() > 1:
        require_cuda()
        device = torch.device(
            "cuda", parallel.rank() % torch.cuda.device_count())
    else:
        device = require_cuda()
    try:
        return _train(args, device)
    finally:
        if joined:
            parallel.destroy()


def _train(args: argparse.Namespace, device: torch.device
           ) -> tp.List[tp.Dict[str, tp.Any]]:
    is_main = parallel.rank() == 0
    base_dir = os.path.join(args.base_dir, args.name)
    hps = get_hparams(args.config, base_dir, save=is_main,
                      params=args.params, force_save=args.force_save)

    seed = getattr(hps.train, "seed", 1)
    random.seed(seed)
    np.random.seed(seed)
    print(f"rank {parallel.rank()} of {parallel.world()}, device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    wrapper = get_wrapper(hps.wrapper)(hps, train=True, device=device)
    wrapper.load()  # resume if a checkpoint exists

    train_dataset, train_loader = get_dataset_dataloader(
        hps, "train", wrapper.keys)
    _, valid_loader = get_dataset_dataloader(
        hps, "valid", getattr(wrapper, "val_keys", wrapper.keys))

    save_interval = getattr(hps.train, "save_interval", 20)
    infer_interval = (getattr(hps.infer, "interval", 20) if "infer" in hps
                      else 0)
    pesq_interval = wrapper.pesq_interval
    max_epochs = hps.train.max_epochs
    sr = hps.data.sampling_rate
    writer_train = writer_valid = None
    if is_main:
        writer_train = EventWriter(os.path.join(base_dir, "train"))
        writer_valid = EventWriter(os.path.join(base_dir, "valid"))
    infer_loader = None

    def write(writer: tp.Optional[EventWriter], epoch: int,
              summary: tp.Dict[str, tp.Any]) -> None:
        if writer is None:
            return
        t = time.perf_counter()
        summarize(writer, epoch, sr, **summary)
        writer.flush()
        wrapper.timing["summarize"] = (wrapper.timing.get("summarize", 0.0)
                                       + time.perf_counter() - t)

    history = []
    try:
        for epoch in range(wrapper.epoch + 1, max_epochs + 1):
            wrapper.epoch = epoch
            wrapper.timing.clear()
            t0 = time.time()
            if hasattr(train_dataset, "shuffle"):
                train_dataset.shuffle(seed + epoch)

            summary = wrapper.train_epoch(train_loader)
            if "load" in wrapper.timing and is_main:
                print(f"epoch {epoch} timing: load "
                      f"{wrapper.timing['load']:.2f}s mix+step "
                      f"{wrapper.timing['step']:.2f}s "
                      f"({wrapper.timing['steps']} steps)")
            # free the shard reader's noise/RIR buffers between epochs
            if hasattr(train_dataset, "release_auxiliary"):
                train_dataset.release_auxiliary()
            summary["scalars"]["lr"] = wrapper.get_lr()
            write(writer_train, epoch, summary)

            calc_metrics = bool(pesq_interval and epoch % pesq_interval == 0)
            summary_v = wrapper.valid_epoch(valid_loader,
                                            calculate_metrics=calc_metrics)
            write(writer_valid, epoch, summary_v)

            record = {"epoch": epoch, "train": summary["scalars"],
                      "valid": summary_v["scalars"]}
            if infer_interval and epoch % infer_interval == 0 and is_main:
                t = time.perf_counter()
                if infer_loader is None:
                    _, infer_loader = get_dataset_dataloader(
                        hps, "infer", wrapper.infer_keys)
                summary_i = wrapper.infer_epoch(infer_loader)
                wrapper.timing["infer"] = time.perf_counter() - t
                write(writer_valid, epoch, summary_i)
                record["infer"] = summary_i["scalars"]

            if is_main and (epoch % save_interval == 0
                            or epoch == max_epochs or wrapper.test):
                wrapper.save(epoch)

            seconds = time.time() - t0
            msg = "  ".join(f"{k.split('/')[-1]} {v:.4f}"
                            for k, v in summary_v["scalars"].items())
            extra = (wrapper.metrics.print()
                     if (wrapper.metrics and calc_metrics) else "")
            if is_main:
                print(f"Epoch {epoch}/{max_epochs}  valid: {msg}{extra}"
                      f"  [{seconds:.1f}s]")
            history.append(dict(record, seconds=seconds,
                                timing=dict(wrapper.timing)))
            if wrapper.test:
                break
    finally:
        if is_main:
            writer_train.close()
            writer_valid.close()
    return history


if __name__ == "__main__":
    main()
