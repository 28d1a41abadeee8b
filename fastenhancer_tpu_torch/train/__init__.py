"""Train, valid and inference steps, and gradient clipping."""
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
    "global_norm",
]
