"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Kernels build at first use (ops/_build.py); importing this package
builds nothing; it registers each kernel as a `torch.ops.fastenhancer.*`
op (ops/_library.py), which the wrappers call. `gru_scan` (a wrapper) and
`segmental_rms` (a plain version) share their modules' names, so they are
imported from ops.gru_scan and ops.segmental_rms and not re-exported
here."""
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
from .gru_scan import gru_fused, gru_scan_reference
from .rnnformer_stack import (
    plan_stack,
    rnnformer_stack_reference,
    rnnformer_stack_step,
)
from .segmental_rms import segmental_rms_fused
from . import _library  # noqa: F401  (registers the ops)

__all__ = ["bsrnn_stack_reference", "bsrnn_stack_step", "plan_band_stack",
           "dprnn_stack_reference", "dprnn_stack_step", "plan_dprnn_stack",
           "dpt_stack_reference", "dpt_stack_step", "plan_dpt_stack",
           "fused_frame_reference", "fused_frame_step", "plan_frame",
           "gru_fused", "gru_scan_reference",
           "plan_stack", "rnnformer_stack_reference", "rnnformer_stack_step",
           "segmental_rms_fused"]
