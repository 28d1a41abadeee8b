"""Builds the CUDA sources under `ops/csrc/` into shared libraries.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
for `sm_90a` (Hopper) into `ops/_build/lib<name>-<hash>.so`, where the hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags, then
loaded with `ctypes`. `build_all` compiles several at once, one `nvcc`
process each. A library is built at its first use in a process and reused
while its source is unchanged. Only the sources in this package are
compiled; nothing is fetched. `nvcc` is found through torch's CUDA_HOME
(the CUDA_HOME or CUDA_PATH variables, `nvcc` on PATH, or the toolkit's
default location).

Every source exports `<name>_f32`, `<name>_bf16` (each returning the
launch's cudaError_t) and `<name>_error_string`; `entry` binds the first
two and `check_launch` raises with the third. `function` binds any other
export (the tensor-core forms and their shared memory sizes); `ld_of`
and `round8` mirror the tiles' padding in `csrc/mma_common.cuh` for the
wrappers' shared-memory counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import typing as tp

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

# every source under csrc/ with a kernel, one per ported TPU kernel
SOURCES = ("rnnformer_stack", "fused_frame", "dpt_stack", "bsrnn_stack",
           "dprnn_stack", "segmental_rms", "gru_scan")
# the activation types every kernel takes, and their entry suffixes
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Hopper's largest dynamic shared memory per thread block (227 KB)
MAX_SMEM_BYTES = 232_448



def round8(n: int) -> int:
    """mma_common.cuh::round8: n rounded up to 8 bf16 values (16 bytes)."""
    return (n + 7) // 8 * 8


def ld_of(n: int) -> int:
    """mma_common.cuh::ld_of: the bf16 row stride of an n-wide tile in
    shared memory, a multiple of 8 with an odd number of 16-byte chunks."""
    r = round8(n)
    return r if (r // 8) % 2 else r + 8


_LIBRARIES: tp.Dict[str, ctypes.CDLL] = {}
# what nvcc reported for each source at its last verbose build (ptxas -v)
REPORTS: tp.Dict[str, str] = {}
_ENTRIES: tp.Dict[tp.Tuple[str, tp.Any], tp.Callable[..., tp.Any]] = {}


def find_nvcc() -> str:
    """Path of the nvcc that builds the kernels; raises if there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit "
                       "(12.x, with sm_90a support) to build the kernels")


def _library_path(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: tp.Sequence[str], verbose: bool = False
              ) -> tp.Dict[str, pathlib.Path]:
    """Compile csrc/<name>.cu for every name whose library is not built
    yet, all nvcc processes at once; returns {name: library path}.
    verbose=True rebuilds, adds `-Xptxas -v`, prints what nvcc reports
    (registers, shared memory and spills per kernel) and keeps it in
    REPORTS."""
    outs = {name: _library_path(name) for name in names}
    todo = [n for n in names if verbose or not outs[n].exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu (exit "
                          f"{proc.returncode}):\n{err}")
            continue
        os.replace(tmp, outs[name])
        if verbose:
            REPORTS[name] = err
            print(f"[build] {name}.cu -> {outs[name].name} "
                  f"({time.perf_counter() - t0:.1f} s since the start)\n"
                  f"{err.strip()}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile csrc/<name>.cu unless its library is already built; returns
    the library path (see build_all)."""
    return build_all([name], verbose)[name]


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, building it first if needed."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBRARIES[name] = lib
    return lib


def entry(name: str, dtype: torch.dtype,
          argtypes: tp.Sequence[tp.Any]) -> tp.Callable[..., int]:
    """The C entry `<name>_<f32|bf16>` of csrc/<name>.cu with its ctypes
    signature declared once: `argtypes` must name every argument (pointers
    and the stream as c_void_p), or ctypes passes a Python int as a 32-bit
    int and cuts the pointer."""
    if dtype not in DTYPE_SUFFIX:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    fn = _ENTRIES.get((name, dtype))
    if fn is None:
        fn = getattr(load_library(name), f"{name}_{DTYPE_SUFFIX[dtype]}")
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _ENTRIES[(name, dtype)] = fn
    return fn


def function(name: str, symbol: str, restype: tp.Any,
             argtypes: tp.Sequence[tp.Any]) -> tp.Callable[..., tp.Any]:
    """Another C function `symbol` of csrc/<name>.cu (a size query), with
    its ctypes signature declared once."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _ENTRIES[(name, symbol)] = fn
    return fn


def check_device(t: torch.Tensor) -> None:
    """Raise for a tensor on neither the CPU nor a CUDA device: the ops
    have a plain version (CPU) and a kernel (CUDA) and nothing else."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def check_launch(name: str, err: int) -> None:
    """Raise if a launch of csrc/<name>.cu returned a CUDA error."""
    if err:
        describe = getattr(load_library(name), f"{name}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({describe(err).decode()})")
