"""The port's native host-IO core (fastenhancer_tpu_torch/native: the
copied fe_native.cpp, built with g++ at first use) on the CPU: shard
members and arrays bit for bit against the JAX package's native walker
and the port's own Python walker (buffer growth included), whole-file wav
decode against the numpy reader for PCM 8/16/24/32 and float, FE_NATIVE=0
taking the Python path, the shard source and read_wav counting their
native calls, and the library built into the directory .gitignore
lists."""
import io
import os
import struct
import tarfile

import numpy as np
import pytest

from fastenhancer_tpu import native as jax_native
from fastenhancer_tpu_torch import native
from fastenhancer_tpu_torch.data.audio_io import _read_riff, read_wav
from fastenhancer_tpu_torch.data.shard import ShardSource

from _torch_parity import write_shard_dir, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16_000


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail("the native library did not build (g++ is on this "
                    "machine)")
    return native


def _wav_bytes(x: np.ndarray, fmt: str) -> bytes:
    """[T] or [T, C] float in [-1, 1) as a RIFF/WAVE of `fmt`, with an odd
    chunk before the data."""
    x = x[:, None] if x.ndim == 1 else x
    if fmt == "pcm8":
        payload, code, bits = ((np.clip(x, -1, 1) * 128 + 128).clip(0, 255)
                               .astype(np.uint8).tobytes(), 1, 8)
    elif fmt == "pcm16":
        payload, code, bits = (np.clip(x * 32768, -32768, 32767)
                               .astype("<i2").tobytes(), 1, 16)
    elif fmt == "pcm24":
        ints = np.clip(x * 8388608, -8388608, 8388607).astype("<i4")
        payload = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        code, bits = 1, 24
    elif fmt == "pcm32":
        payload, code, bits = ((np.clip(x, -1, 1) * 2147483000)
                               .astype("<i4").tobytes(), 1, 32)
    elif fmt == "f32":
        payload, code, bits = x.astype("<f4").tobytes(), 3, 32
    else:
        payload, code, bits = x.astype("<f8").tobytes(), 3, 64
    block = x.shape[1] * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", code, x.shape[1], SR, SR * block,
                            block, bits)
    chunks = (b"fmt " + struct.pack("<I", 16) + fmt_chunk + b"junk"
              + struct.pack("<I", 5) + b"odd!!\0" + b"data"
              + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _tars(root):
    d = write_shard_dir(root, "speech", seed=5, n_shards=2, cuts=5,
                        dur=(0.2, 1.5))
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".tar"))


def _python_walk(tar_path, monkeypatch):
    monkeypatch.setenv("FE_NATIVE", "0")
    try:
        return list(ShardSource._iter_tar_audio(tar_path))
    finally:
        monkeypatch.delenv("FE_NATIVE")


def test_shard_members_match_jax_native_and_python_walker(lib, tmp_path,
                                                           monkeypatch):
    assert jax_native.available()
    for tar_path in _tars(tmp_path):
        got = list(lib.shard_members(tar_path, buf_floats=4096))
        want = list(jax_native.shard_members(tar_path))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        launches = lib.shard_members.launches
        walked = list(ShardSource._iter_tar_audio(tar_path))
        assert lib.shard_members.launches == launches + 1
        python = _python_walk(tar_path, monkeypatch)
        assert lib.shard_members.launches == launches + 1
        assert [s for s, _ in walked] == [s for s, _ in python] == [
            os.path.basename(n).rsplit(".", 1)[0] for n, _ in got]
        for (_, a), (_, b), (_, c) in zip(walked, python, got):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_shard_members_non_wav_and_errors(lib, tmp_path):
    tar_path = str(tmp_path / "recording.000000.tar")
    blob = b"\x01\x02zz" * 33
    with tarfile.open(tar_path, "w", format=tarfile.USTAR_FORMAT) as tar:
        for name, data in (("a.wav", _wav_bytes(np.zeros(10), "pcm16")),
                           ("meta.bin", blob)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    got = list(lib.shard_members(tar_path))
    assert [n for n, _ in got] == ["a.wav", "meta.bin"] and got[1][1] == blob
    with pytest.raises(OSError):
        list(lib.shard_members(str(tmp_path / "missing.tar")))


@pytest.mark.parametrize("fmt", ["pcm8", "pcm16", "pcm24", "pcm32", "f32",
                                 "f64"])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_file_matches_numpy(lib, tmp_path, fmt, channels):
    rng = np.random.default_rng(channels * 10 + len(fmt))
    x = (rng.standard_normal((1500, channels)) * 0.4).astype(np.float32)
    raw = _wav_bytes(x.squeeze(1) if channels == 1 else x, fmt)
    path = tmp_path / f"{fmt}.wav"
    path.write_bytes(raw)
    got, sr = lib.read_wav_file(str(path))
    want, want_sr = _read_riff(io.BytesIO(raw[12:]))
    want = (want.mean(axis=1) if want.ndim == 2 else want).astype(np.float32)
    assert sr == want_sr == SR and got.shape == want.shape
    if channels == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # read_wav takes the native path: one more native call
    launches = lib.read_wav_file.launches
    x_read, _ = read_wav(str(path))
    assert lib.read_wav_file.launches == launches + 1
    np.testing.assert_array_equal(x_read, got)


def test_read_wav_file_buffer_growth_and_errors(lib, tmp_path):
    x = np.linspace(-0.5, 0.5, (1 << 20) + 4321).astype(np.float32)
    path = tmp_path / "big.wav"
    path.write_bytes(_wav_bytes(x, "f32"))
    got, sr = lib.read_wav_file(str(path))
    np.testing.assert_array_equal(got, x)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFxxxxWAVEjunk")
    with pytest.raises(ValueError):
        lib.read_wav_file(str(bad))
    with pytest.raises(OSError):
        lib.read_wav_file(str(tmp_path / "missing.wav"))


def test_fe_native_0_takes_the_python_path(lib, tmp_path, monkeypatch):
    (tar_path, _) = _tars(tmp_path)
    path = tmp_path / "one.wav"
    path.write_bytes(_wav_bytes(np.full(100, 0.25, np.float32), "pcm16"))
    monkeypatch.setenv("FE_NATIVE", "0")
    assert not native.available()
    counts = (lib.shard_members.launches, lib.read_wav_file.launches)
    assert list(ShardSource._iter_tar_audio(tar_path))
    x, _ = read_wav(str(path))
    assert (lib.shard_members.launches, lib.read_wav_file.launches) == counts
    np.testing.assert_array_equal(x, np.full(100, 0.25, np.float32))
    monkeypatch.delenv("FE_NATIVE")
    assert native.available()


def test_shard_source_reads_natively(lib, tmp_path):
    d = os.path.dirname(_tars(tmp_path)[0])
    launches = lib.shard_members.launches
    cuts = list(ShardSource(d).iter_cuts(seed=0))
    assert len(cuts) == 10
    assert lib.shard_members.launches == launches + 2


def test_library_lands_in_the_ignored_build_dir(lib):
    path = lib.library_path()
    assert os.path.dirname(path) == lib.BUILD_DIR
    assert os.path.basename(path).startswith("fe_native-")
    rel = os.path.relpath(lib.BUILD_DIR, REPO).replace(os.sep, "/") + "/"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel in f.read().split()
