"""PyTorch/CUDA port of fastenhancer_tpu for NVIDIA Hopper (H100).

The JAX package `fastenhancer_tpu` is the reference; this package mirrors its
module paths (`functional/stft.py`, `nn/`, `ops/`, `models/`, `serving.py`)
so each module's counterpart is easy to find. It imports `torch` and never
`jax`. Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels under `ops/csrc/`, built with `nvcc` at first use.
Importing the package, or its `data`, `utils` and `scripts` packages,
imports no torch: the host tools (`scripts/data/`) and their spawned
workers start without it.
"""
__version__ = "0.1.0"


def require_cuda():
    """The first CUDA device (a torch.device); raises RuntimeError when
    there is none."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (torch "
                           f"{torch.__version__}, CUDA {torch.version.cuda})")
    return torch.device("cuda", 0)


__all__ = ["__version__", "require_cuda"]
