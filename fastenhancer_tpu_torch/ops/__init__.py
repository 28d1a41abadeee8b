"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Kernels build at first use (ops/_build.py); importing this package
builds nothing."""
from .bsrnn_stack import (
    bsrnn_stack_reference,
    bsrnn_stack_step,
    plan_band_stack,
)
from .dprnn_stack import (
    dprnn_stack_reference,
    dprnn_stack_step,
    plan_dprnn_stack,
)
from .dpt_stack import dpt_stack_reference, dpt_stack_step, plan_dpt_stack
from .fused_frame import fused_frame_reference, fused_frame_step, plan_frame
from .rnnformer_stack import (
    plan_stack,
    rnnformer_stack_reference,
    rnnformer_stack_step,
)

__all__ = ["bsrnn_stack_reference", "bsrnn_stack_step", "plan_band_stack",
           "dprnn_stack_reference", "dprnn_stack_step", "plan_dprnn_stack",
           "dpt_stack_reference", "dpt_stack_step", "plan_dpt_stack",
           "fused_frame_reference", "fused_frame_step", "plan_frame",
           "plan_stack", "rnnformer_stack_reference", "rnnformer_stack_step"]
