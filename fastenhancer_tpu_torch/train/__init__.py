"""Train, valid and inference steps, gradient clipping and checkpoints.

`python -m fastenhancer_tpu_torch.train` is the training entry point
(`train/__main__.py`)."""
from .checkpoint import (
    clean_checkpoints,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .grad_clip import (
    clip_grad_norm,
    clip_grad_norm_local,
    clip_grad_value,
    global_norm,
    make_clipper,
)
from .step import make_infer_fn, make_train_step, make_valid_step

__all__ = [
    "make_train_step", "make_valid_step", "make_infer_fn", "make_clipper",
    "clip_grad_norm", "clip_grad_norm_local", "clip_grad_value",
    "global_norm", "save_checkpoint", "latest_checkpoint", "load_checkpoint",
    "clean_checkpoints",
]
