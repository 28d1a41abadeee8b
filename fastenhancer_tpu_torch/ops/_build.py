"""Builds the CUDA sources under `ops/csrc/` into shared libraries.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
for `sm_90a` (Hopper) into `ops/_build/lib<name>-<hash>.so`, where the hash
covers the source and the flags, then loaded with `ctypes`. A library is
built at its first use in a process and reused while its source is
unchanged. Only the sources in this package are compiled; nothing is
fetched. `nvcc` is found through torch's CUDA_HOME (the CUDA_HOME or
CUDA_PATH variables, `nvcc` on PATH, or the toolkit's default location).
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

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LIBRARIES: tp.Dict[str, ctypes.CDLL] = {}


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


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile csrc/<name>.cu unless its library is already built; returns
    the library path. verbose=True adds `-Xptxas -v` and prints what nvcc
    reports (registers, shared memory and spills per kernel)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(f"[build] {name}.cu -> {out.name} in "
              f"{time.perf_counter() - t0:.1f} s\n{proc.stderr.strip()}")
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, building it first if needed."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBRARIES[name] = lib
    return lib
