"""Entry points that run a trained checkpoint on one device.

    python -m fastenhancer_tpu_torch.scripts.enhance     # wavs, offline graph
    python -m fastenhancer_tpu_torch.scripts.serve       # the StreamingEngine
    python -m fastenhancer_tpu_torch.scripts.metrics_ns  # SISDR/STOI/PESQ
    python -m fastenhancer_tpu_torch.scripts.train_demo  # FE-T from scratch

The counterparts of the repo's scripts/{enhance,serve,metrics_ns}.py: the
same flags and printed lines, plus `--device` (the first CUDA card unless
named; `--device cpu` runs the kernels' plain versions, as the CPU tests
do). Each loads a run from {base_dir}/{name} (its config.yaml and newest
or `--epoch` checkpoint, written by `python -m fastenhancer_tpu_torch.train`
or by the JAX package's train.py). `train_demo` instead trains FE-T from
scratch and scores it with `metrics_ns` (its docstring).
"""
import importlib
import os
import typing as tp

from .. import require_cuda

__all__ = ["add_run_args", "load_run", "train_demo"]


def __getattr__(name):
    """`train_demo` on first use: importing the package imports no torch."""
    if name != "train_demo":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return importlib.import_module(f".{name}", __name__)


def load_run(name: str, base_dir: str, epoch: tp.Optional[int],
             device: tp.Optional[str],
             params: tp.Optional[tp.List[str]] = None):
    """-> (hps, wrapper) of the run's checkpoint on `device` (the card
    unless named); raises FileNotFoundError without a checkpoint."""
    import torch

    from ..utils.hparams import get_hparams
    from ..wrappers import get_wrapper

    dev = require_cuda() if device is None else torch.device(device)
    hps = get_hparams(None, base_dir=os.path.join(base_dir, name),
                      params=params)
    wrapper = get_wrapper(hps.wrapper)(hps, train=False, device=dev)
    if not wrapper.load(epoch):
        raise FileNotFoundError(f"no checkpoint in {hps.base_dir}")
    return hps, wrapper


def add_run_args(ap) -> None:
    """The flags every script shares: -n, --base_dir, --epoch, --device."""
    ap.add_argument("-n", "--name", required=True)
    ap.add_argument("--base_dir", default="logs")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                         "raises when there is none)")
