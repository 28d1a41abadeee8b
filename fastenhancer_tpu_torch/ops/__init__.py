"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Kernels build at first use (ops/_build.py); importing this package
builds nothing."""
from .rnnformer_stack import (
    plan_stack,
    rnnformer_stack_reference,
    rnnformer_stack_step,
)

__all__ = ["plan_stack", "rnnformer_stack_reference", "rnnformer_stack_step"]
