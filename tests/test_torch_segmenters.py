"""The port's segmenters, preprocessors and RIR CSV generators
(fastenhancer_tpu_torch/scripts/data/) against the JAX package's
(scripts/data/): each `main(argv)` in-process on one seeded synthetic
corpus into separate directories, the port's spawned pool once; equal
means the same wav bytes (and symlinks), or the same CSV text."""
import builtins
import importlib
import os

import numpy as np
import pytest

from fastenhancer_tpu_torch.data.audio_io import write_wav

from _torch_parity import deadline, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16000
POOL_TIMEOUT = 240  # seconds for a tool's run with its spawned pool


def _speech(rng, seconds, sr=SR, gaps=True):
    """Tone bursts; with `gaps`, silent stretches every ~1.3 s."""
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 500) * t)
    if gaps:
        x *= (np.sin(2 * np.pi * 0.38 * t + rng.uniform(0, 6)) > -0.5)
    return (x + 1e-4 * rng.standard_normal(len(t))).astype(np.float32)


def _tree(root):
    """{relative path: wav/CSV bytes, or ("link", target) for a symlink}."""
    out = {}
    for dirpath, dirs, names in os.walk(root):
        for n in dirs + names:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.readlink(p))
            elif os.path.isfile(p):
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


def _put(path, x, sr=SR):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, x, sr)


def _daps(root):
    rng = np.random.default_rng(1)
    for i in range(3):
        _put(os.path.join(root, f"f{i}_script1_produced.wav"),
             _speech(rng, 7.0 + i))
    return root


def _ears(root):
    rng = np.random.default_rng(2)
    for spk in ("p001", "p002"):
        t = np.arange(7 * SR) / SR
        rumble = 0.05 * np.sin(2 * np.pi * 30 * t).astype(np.float32)
        _put(os.path.join(root, spk, "emo_read.wav"),
             _speech(rng, 7.0) + rumble)
    return root


def _mats(root, version):
    """A 48 kHz 2-channel RIR bank as MATLAB v5 (scipy) or v7.3 (HDF5,
    column-major, so h5py sees it transposed)."""
    sr_in = 48000
    t = np.arange(sr_in // 2) / sr_in
    data = np.stack([np.sin(2 * np.pi * 500 * t) * np.exp(-8 * t),
                     0.25 * np.sin(2 * np.pi * 800 * t)], axis=1)
    os.makedirs(os.path.join(root, "room1"))
    if version == "v7.3":
        import h5py

        with h5py.File(os.path.join(root, "room1", "a.mat"), "w") as f:
            f["data"] = data.T
            f["fs"] = np.array([[float(sr_in)]])
    else:
        from scipy.io import savemat

        savemat(os.path.join(root, "room1", "a.mat"), {"data": data,
                                                       "fs": sr_in})
        savemat(os.path.join(root, "b.mat"), {"data": data[:, :1] * 3.0,
                                              "fs": 16000})
    return root


def _expresso(root):
    rng = np.random.default_rng(3)
    conv = os.path.join(root, "conversational", "ex01")
    _put(os.path.join(conv, "ex01_convo.wav"), np.stack(
        [_speech(rng, 6.0), _speech(rng, 6.0)], 1))
    _put(os.path.join(root, "read", "spk1", "narration", "longform",
                      "spk1_narr_long.wav"), _speech(rng, 5.0))
    os.makedirs(os.path.join(root, "read", "spk1", "narration", "base"))
    os.makedirs(os.path.join(root, "read", "spk1", "enunciated", "base"))
    vad = os.path.join(root, "VAD_segments.txt")
    with open(vad, "w") as f:
        f.write("ex01_convo/channel1\t(0.50, 3.00), (3.20, 5.90)\n"
                "ex01_convo/channel2\t(2.50, 4.00)\n"
                "spk1_narr_long\t(0.20, 4.80)\n"
                "# a comment\n\nnot_there\t(0.0, 1.0)\n")
    return root, vad


def _rir_trees(root):
    rng = np.random.default_rng(4)
    for sub, ch in (("rev_low", 3), ("rev_medium", 1), ("rev_high", 2)):
        for name in ("b", "a"):
            _put(os.path.join(root, "brudex", sub, f"{name}.wav"),
                 (0.1 * rng.standard_normal((800, ch))).astype(np.float32))
    for sub in ("SAL", "AIL"):
        for p in ("P2", "P1"):
            _put(os.path.join(root, "myriad", sub, p, "rir.wav"),
                 (0.1 * rng.standard_normal(800)).astype(np.float32))
    return root


# case -> (tool, corpus writer(root) -> its dir, argv(that dir, out dir)):
# the port's pool is spawned where argv asks for 2 workers
SEGMENTER_CASES = {
    "segment_daps": ("segment_daps", _daps, lambda src, o: [
        "--src-dir", src, "--out-dir", o, "--min-dur", "1.0",
        "--max-dur", "3.0", "--tail-min", "0.5", "--num-workers", "1"]),
    "segment_daps-spawned": ("segment_daps", _daps, lambda src, o: [
        "--src-dir", src, "--out-dir", o, "--min-dur", "1.0",
        "--max-dur", "3.0", "--tail-min", "0.5", "--num-workers", "2"]),
    "segment_ears": ("segment_ears", _ears, lambda src, o: [
        "--src-dir", src, "--out-dir", o, "--min-dur", "1.0",
        "--max-dur", "3.0", "--num-workers", "1"]),
    "segment_ears-pcm16": ("segment_ears", _ears, lambda src, o: [
        "--src-dir", src, "--out-dir", o, "--min-dur", "1.5",
        "--max-dur", "2.5", "--subtype", "pcm16", "--highpass-hz", "0",
        "--num-workers", "1"]),
}


def _expresso_argv(strategy):
    return lambda src, o: [
        "--dataset-root", src[0], "--vad-file", src[1], "--output-dir", o,
        "--strategy", strategy, "--max-dur", "2.0", "--min-dur", "1.0",
        "--tail-min", "0.5"]


def _brudex_argv(src, o):
    return ["--from-dir", src, "--to-dir", o, "--num-workers", "1"]


PREPROCESSOR_CASES = {
    "preprocess_brudex-v5": ("preprocess_brudex",
                             lambda r: _mats(r, "v5"), _brudex_argv),
    "preprocess_brudex-v7.3": ("preprocess_brudex",
                               lambda r: _mats(r, "v7.3"), _brudex_argv),
    "preprocess_expresso-vad": ("preprocess_expresso", _expresso,
                                _expresso_argv("vad")),
    "preprocess_expresso-fixed": ("preprocess_expresso", _expresso,
                                  _expresso_argv("fixed")),
}


def _run_both(tmp_path, tool, write, argv):
    src = write(str(tmp_path / "corpus"))
    trees = []
    for pkg in ("scripts.data", "fastenhancer_tpu_torch.scripts.data"):
        out = str(tmp_path / pkg.split(".")[0])
        with deadline(POOL_TIMEOUT, f"{pkg}.{tool}"):
            importlib.import_module(f"{pkg}.{tool}").main(argv(src, out))
        trees.append(_tree(out))
    return trees


@pytest.mark.parametrize("case", list(SEGMENTER_CASES))
def test_segmenter_equals_jax(tmp_path, case):
    want, got = _run_both(tmp_path, *SEGMENTER_CASES[case])
    assert sum(k.endswith(".wav") for k in want) >= 4, sorted(want)
    assert got == want


@pytest.mark.parametrize("case", list(PREPROCESSOR_CASES))
def test_preprocessor_equals_jax(tmp_path, case):
    want, got = _run_both(tmp_path, *PREPROCESSOR_CASES[case])
    assert any(k.endswith(".wav") for k in want), sorted(want)
    assert got == want


@pytest.mark.parametrize("tool", ["gen_brudex_csv", "gen_myriad_csv"])
def test_csv_generator_equals_jax(tmp_path, tool):
    sub = tool.split("_")[1]
    base = os.path.join(_rir_trees(str(tmp_path / "corpus")), sub)
    texts = []
    for pkg in ("scripts.data", "fastenhancer_tpu_torch.scripts.data"):
        out = str(tmp_path / pkg.split(".")[0] / "rir.csv")
        importlib.import_module(f"{pkg}.{tool}").main(
            ["--base-dir", base, "-o", out])
        with open(out, newline="") as f:
            texts.append(f.read())
    assert texts[0].count("\n") >= 5 and texts[1] == texts[0]


def test_preprocess_brudex_v73_without_h5py_raises(tmp_path, monkeypatch):
    """Without h5py a MATLAB v7.3 file stops the port's run with an
    ImportError naming h5py; no file is skipped."""
    from fastenhancer_tpu_torch.scripts.data.preprocess_brudex import main

    src = _mats(str(tmp_path / "mat"), "v7.3")
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        main(["--from-dir", src, "--to-dir", str(tmp_path / "out"),
              "--num-workers", "1"])
    assert not (tmp_path / "out").exists()
