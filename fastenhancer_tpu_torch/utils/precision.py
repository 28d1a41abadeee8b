"""The entry points' float32 policy.

On a CUDA card PyTorch may run float32 work in TF32 (a 10-bit mantissa):
convolutions whenever `torch.backends.cudnn.allow_tf32` is True, which is
PyTorch's default, and products whenever
`torch.backends.cuda.matmul.allow_tf32` is True. The port's float32 is
held to the JAX package's float32, computed in full float32 (to 1e-5 of a
module's output), which TF32 misses by about 1e-4 of the peak.

So every entry point (`python -m fastenhancer_tpu_torch.train`, and
`scripts.{serve,enhance,metrics_ns,export,run_exported}`) calls
`full_float32()` first in its `main`, before it reads its arguments.
Library functions (`Model.stream`, `StreamingEngine`, the op wrappers)
leave these process-wide flags alone: a Python caller who wants the JAX
package's float32 calls `full_float32()` itself, or sets both flags to
False. bfloat16 work is the same either way.
"""
import torch

__all__ = ["full_float32"]


def full_float32() -> None:
    """Run float32 products and convolutions in full float32 (no TF32) in
    this process from now on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
