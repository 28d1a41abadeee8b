"""The seven hand-written kernels as `torch.library` ops, namespace
`fastenhancer`.

Each op has three implementations, all in the kernel's own module:

* `CUDA`: `cuda_impl`, the ctypes launch of the kernel (built at first
  use; raises if it cannot build or launch). It counts the launch on the
  wrapper (`rnnformer_stack_step.launches`, `gru_scan.tc_launches`, ...),
  so launches are counted when they run, in eager code and in an exported
  program alike, and never while tracing. It never runs the plain version.
* `CPU`: `cpu_impl`, the plain version.
* fake (`register_fake`): `fake_impl`, the output shapes and types, so
  that `torch.export` traces each kernel as one node and never reaches a
  ctypes call (a fake tensor has no `data_ptr`).

A plan dict crosses the op boundary as a `Tensor[]` in its module's
`PLAN_KEYS` order (the block stack's LN form appends `LN_KEYS` and passes
its eps as `ln_eps`; the whole frame passes its frame and stack arrays as
two lists). The dpt stack declares its K/V caches mutated (`Tensor(a!)`),
as it writes the frame's slot in place. The GRU scan's CPU implementation
is differentiable (`gru_scan.autograd_cpu_impl`, registered for the CPU
alone, so that a CUDA call pays no Python autograd layer), as its plain
version was.

The Python wrappers (`rnnformer_stack_step`, `gru_scan`, ...) check their
operands and call `torch.ops.fastenhancer.*`, so eager and exported code
take one route. The ops are defined with `Library.define`/`impl`, which
costs less per call than `@torch.library.custom_op`. Importing
`fastenhancer_tpu_torch.ops` registers them; this module is imported
once, by the package.
"""
import torch

from . import bsrnn_stack, dprnn_stack, dpt_stack, fused_frame
from . import gru_scan as _gru_scan
from . import rnnformer_stack
from . import segmental_rms as _segmental_rms

NAMESPACE = "fastenhancer"

# op name -> (its module, its schema after the name)
OPS = {
    "rnnformer_stack": (
        rnnformer_stack,
        "(Tensor[] plan, Tensor x, Tensor h, int num_heads, float? ln_eps)"
        " -> (Tensor, Tensor)"),
    "fused_frame": (
        fused_frame,
        "(Tensor[] frame, Tensor[] stack, Tensor x, Tensor h, int num_heads,"
        " int[] enc_ks, int f_enc, int block_freq, int stride, bool resnet,"
        " str? mask) -> (Tensor, Tensor)"),
    "dpt_stack": (
        dpt_stack,
        "(Tensor[] plan, Tensor x, Tensor(a!) kc, Tensor(b!) vc, Tensor ptr,"
        " int num_heads) -> (Tensor, Tensor)"),
    "bsrnn_stack": (
        bsrnn_stack,
        "(Tensor[] plan, Tensor x, Tensor h) -> (Tensor, Tensor)"),
    "dprnn_stack": (
        dprnn_stack,
        "(Tensor[] plan, Tensor x, Tensor h) -> (Tensor, Tensor)"),
    "gru_scan": (
        _gru_scan,
        "(Tensor x_proj, Tensor h0, Tensor w_hh, Tensor b_hh)"
        " -> (Tensor, Tensor)"),
    "segmental_rms": (
        _segmental_rms,
        "(Tensor wav, int sr, int window_ms, float relative_threshold_db,"
        " float? absolute_threshold_db) -> Tensor"),
}

LIBRARY = torch.library.Library(NAMESPACE, "DEF")
for _name, (_module, _schema) in OPS.items():
    LIBRARY.define(_name + _schema)
    LIBRARY.impl(_name, _module.cpu_impl, "CPU")
    LIBRARY.impl(_name, _module.cuda_impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _module.fake_impl,
                                lib=LIBRARY)
# the GRU scan's gradient, on the CPU only: a CUDA call skips this layer
LIBRARY.impl("gru_scan", _gru_scan.autograd_cpu_impl, "AutogradCPU")
