"""Native host-IO runtime: build and ctypes bindings for fe_native.cpp.

Counterpart of fastenhancer_tpu/native/__init__.py. The shared library is
compiled at first use with the system g++ into ``_build/`` beside this file
(named by the source's hash, moved into place atomically, so processes
that build it at once agree) and loaded with ctypes. ``available()`` is
False when g++ is missing or the build fails, and with ``FE_NATIVE=0``;
every caller then keeps its pure-Python path (data/shard.py,
data/audio_io.py).

Exposed:
  * ``shard_members(tar_path)``: walk a plain-ustar shard tar, yielding
    ``(member_name, float32 mono ndarray)`` for wav members and
    ``(member_name, bytes)`` for anything else;
  * ``read_wav_file(path)``: whole-file wav -> (float32 mono, sr).

Each counts its native calls, as the kernels' wrappers count launches:
``shard_members.launches`` (tars walked) and ``read_wav_file.launches``
(files decoded), so a run can show which path it took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import typing as tp

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fe_native.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_LIB: tp.Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> tp.Optional[str]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"fe_native-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)  # atomic: concurrent builds write the same file
    return out


def _load() -> tp.Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.fe_shard_open.restype = ctypes.c_void_p
        lib.fe_shard_open.argtypes = [ctypes.c_char_p]
        lib.fe_shard_close.restype = None
        lib.fe_shard_close.argtypes = [ctypes.c_void_p]
        lib.fe_shard_next.restype = ctypes.c_int
        lib.fe_shard_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int)]
        lib.fe_shard_payload.restype = ctypes.c_int64
        lib.fe_shard_payload.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.fe_read_wav_file.restype = ctypes.c_int
        lib.fe_read_wav_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.fe_native_abi.restype = ctypes.c_int
        lib.fe_native_abi.argtypes = []
        if lib.fe_native_abi() != 1:
            return None
        _LIB = lib
        return _LIB


def library_path() -> tp.Optional[str]:
    """The loaded library's file (None when it is not loaded)."""
    return None if _LIB is None else _LIB._name


def available() -> bool:
    """True when the library builds and loads and FE_NATIVE is not 0."""
    if os.environ.get("FE_NATIVE", "1") in ("0", "false", "off"):
        return False
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (check available())")
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def shard_members(tar_path: str, buf_floats: int = 1 << 20
                  ) -> tp.Iterator[tp.Tuple[str, tp.Union[np.ndarray, bytes]]]:
    """Walk a plain-ustar tar natively; one handle per caller thread.

    Raises the errors the Python walker raises (mixed-format tar, bad wav
    entry), so data/shard.py handles either path the same way."""
    lib = _lib()
    h = lib.fe_shard_open(tar_path.encode())
    if not h:
        raise OSError(f"cannot open {tar_path}")
    shard_members.launches += 1
    buf = np.empty(buf_floats, np.float32)
    name = ctypes.create_string_buffer(256)
    n_out = ctypes.c_int64()
    sr = ctypes.c_int()
    try:
        while True:
            rc = lib.fe_shard_next(h, _f32p(buf), buf.size, name, 256,
                                   ctypes.byref(n_out), ctypes.byref(sr))
            if rc == 1:
                return
            if rc == -2:  # member pending: grow and retry
                buf = np.empty(int(n_out.value), np.float32)
                continue
            mname = name.value.decode()
            if rc == 0:
                yield mname, buf[: int(n_out.value)].copy()
            elif rc == 2:
                payload = np.empty(int(n_out.value), np.uint8)
                got = lib.fe_shard_payload(
                    h, payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    payload.size)
                if got != payload.size:
                    raise ValueError(f"short payload for {mname} in "
                                     f"{tar_path}: {got} of {payload.size}")
                yield mname, payload.tobytes()
            elif rc == -4:
                raise ValueError(f"bad wav entry: {mname}")
            elif rc == -6:
                raise ValueError(
                    f"mixed-format tar {tar_path}: rebuild the shard with "
                    f"uniform ustar members")
            else:
                raise ValueError(f"malformed tar {tar_path} (status {rc})")
    finally:
        lib.fe_shard_close(h)


def read_wav_file(path: str) -> tp.Tuple[np.ndarray, int]:
    """Whole-file native decode -> (float32 mono, sample_rate)."""
    lib = _lib()
    read_wav_file.launches += 1
    buf = np.empty(1 << 20, np.float32)
    n_out = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.fe_read_wav_file(path.encode(), _f32p(buf), buf.size,
                              ctypes.byref(n_out), ctypes.byref(sr))
    if rc == -2:
        buf = np.empty(int(n_out.value), np.float32)
        rc = lib.fe_read_wav_file(path.encode(), _f32p(buf), buf.size,
                                  ctypes.byref(n_out), ctypes.byref(sr))
    if rc == -1:
        raise OSError(f"cannot read {path}")
    if rc != 0:
        raise ValueError(f"not a decodable RIFF/WAVE file: {path}")
    return buf[: int(n_out.value)].copy(), int(sr.value)


shard_members.launches = 0
read_wav_file.launches = 0

__all__ = ["available", "shard_members", "read_wav_file", "library_path",
           "BUILD_DIR"]
