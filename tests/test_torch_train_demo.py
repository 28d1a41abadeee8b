"""The port's training demo (fastenhancer_tpu_torch/scripts/train_demo.py)
against the JAX package's (scripts/train_demo.py) on one seeded 48 kHz
recording of 12.5 s (4 utterances: 2 to train on, 2 held out), both
modules' `BUNDLED` pointed at it.

- `build_corpus`: the same file names in the same splits, samples within
  1e-6, the same `corpus:` line;
- `build_shards`: the same tar members byte for byte and the same
  decompressed cut lists (a `.gz` header holds the time it was written);
- `main` on both recipes, its children faked: the `demo.yaml` that each
  writes loads to the same dict (the port's through `yaml_subset`, JAX's
  through pyyaml), the corpus paths aside;
- the children: the port's training CLI and `metrics_ns`, `--device`
  passed through to both, the noisy baseline's line equal to JAX's, and a
  failing child's return code is the demo's exit code.

No training runs here: the card runs the demo end to end
(`chip_smoke.py`, phase 30)."""
import gzip
import os
import sys
import tarfile
import types

import numpy as np
import pytest
import yaml

import scripts.train_demo as jax_demo
from fastenhancer_tpu_torch.data.audio_io import read_wav, write_wav
from fastenhancer_tpu_torch.scripts import train_demo as demo
from fastenhancer_tpu_torch.utils import yaml_subset

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 12.5


@pytest.fixture(scope="module")
def bundled(tmp_path_factory):
    """A seeded 48 kHz stand-in of the bundled recording: voiced harmonic
    stretches with pauses and noise."""
    sr = 48_000
    rng = np.random.default_rng(23)
    t = np.arange(int(SECONDS * sr)) / sr
    f0 = 120 + 60 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    x *= (np.sin(2 * np.pi * 4 * t) > -0.3)
    x = 0.2 * x / np.abs(x).max() + 0.003 * rng.standard_normal(len(t))
    path = str(tmp_path_factory.mktemp("bundled") / "standin.wav")
    write_wav(path, x.astype(np.float32), sr)
    return path


@pytest.fixture
def both_bundled(bundled, monkeypatch):
    monkeypatch.setattr(jax_demo, "BUNDLED", bundled)
    monkeypatch.setattr(demo, "BUNDLED", bundled)
    monkeypatch.chdir(REPO)   # both read configs/ from the working dir


@pytest.fixture(scope="module")
def corpora(bundled, tmp_path_factory):
    """Each package's corpus and shards in a directory of its own, with
    what build_corpus printed: {"jax"|"port": (workdir, dirs, shards,
    printed)}."""
    import contextlib
    import io

    out = {}
    for side, mod in (("jax", jax_demo), ("port", demo)):
        work = str(tmp_path_factory.mktemp(side))
        saved, mod.BUNDLED = mod.BUNDLED, bundled
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                dirs = mod.build_corpus(work, seed=0)
            shards = mod.build_shards(work, dirs, seed=0)
        finally:
            mod.BUNDLED = saved
        out[side] = (work, dirs, shards, buf.getvalue())
    return out


def _rel(d, work):
    return os.path.relpath(d, work)


def test_build_corpus_matches_jax(corpora):
    (jw, jdirs, _, jline), (pw, pdirs, _, pline) = (corpora["jax"],
                                                    corpora["port"])
    assert pline.replace(pw, "W") == jline.replace(jw, "W")
    assert pline.startswith("corpus: 2 train / 2 held-out utterances")
    assert {k: _rel(v, pw) for k, v in pdirs.items()} == \
        {k: _rel(v, jw) for k, v in jdirs.items()}
    for key, d in jdirs.items():
        names = sorted(os.listdir(d))
        assert names == sorted(os.listdir(pdirs[key])), key
        assert len(names) == 2, key
        for name in names:
            want, sr = read_wav(os.path.join(d, name))
            got, psr = read_wav(os.path.join(pdirs[key], name))
            assert sr == psr == demo.SR
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f"{key}/{name}")


def _shard_contents(d):
    """{file: {member: bytes}} of a shard dir's tars and {file: lines} of
    its decompressed cut lists."""
    out = {}
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        if f.endswith(".tar"):
            with tarfile.open(p) as tar:
                out[f] = {m.name: tar.extractfile(m).read()
                          for m in tar.getmembers()}
        elif f.endswith(".gz"):
            with gzip.open(p, "rt") as fh:
                out[f] = fh.read().splitlines()
    return out


def test_build_shards_matches_jax(corpora):
    (jw, _, jshards, _), (pw, _, pshards, _) = corpora["jax"], corpora["port"]
    assert {k: _rel(v, pw) for k, v in pshards.items()} == \
        {k: _rel(v, jw) for k, v in jshards.items()}
    for kind, d in jshards.items():
        want, got = _shard_contents(d), _shard_contents(pshards[kind])
        assert any(f.endswith(".tar") for f in want), kind
        assert got.keys() == want.keys(), kind
        for f in want:
            assert got[f] == want[f], (kind, f)


class FakeRun:
    """subprocess.run, recording each command and answering the i-th with
    returncodes[i] (0 past the list)."""

    def __init__(self, *returncodes):
        self.codes, self.calls = list(returncodes), []

    def __call__(self, cmd, **kwargs):
        import subprocess

        self.calls.append(list(cmd))
        code = self.codes[len(self.calls) - 1] \
            if len(self.calls) <= len(self.codes) else 0
        return subprocess.CompletedProcess(cmd, code)


def _run_jax(monkeypatch, argv, fake):
    # the module's own name only: subprocess.run stays real for the rest
    monkeypatch.setattr(jax_demo, "subprocess",
                        types.SimpleNamespace(run=fake))
    monkeypatch.setattr(sys, "argv", ["train_demo.py", *argv])
    with pytest.raises(SystemExit) as e:
        jax_demo.main()
    return e.value.code


def _run_port(monkeypatch, argv, fake):
    # the module's own name only: subprocess.run stays real for the rest
    monkeypatch.setattr(demo, "subprocess",
                        types.SimpleNamespace(run=fake))
    try:
        return demo.main(argv)
    except SystemExit as e:
        return e.code


def _paths_as(tree, work, to):
    """The tree with every string that starts with `work` rebased on `to`."""
    if isinstance(tree, dict):
        return {k: _paths_as(v, work, to) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths_as(v, work, to) for v in tree]
    if isinstance(tree, str) and tree.startswith(work):
        return to + tree[len(work):]
    return tree


@pytest.mark.usefixtures("both_bundled")
@pytest.mark.parametrize("recipe,epochs", [("paired", 8), ("shard", 3)])
def test_demo_yaml_matches_jax(recipe, epochs, tmp_path, monkeypatch):
    """Both mains stop after a failing training child, with its code; the
    configs they wrote load to the same dict."""
    trees = {}
    for side, run in (("jax", _run_jax), ("port", _run_port)):
        work = str(tmp_path / side)
        code = run(monkeypatch, ["--workdir", work, "--recipe", recipe,
                                 "--epochs", str(epochs)], FakeRun(3))
        assert code == 3, side
        with open(os.path.join(work, "demo.yaml")) as f:
            text = f.read()
        tree = yaml.safe_load(text) if side == "jax" else \
            yaml_subset.load(text)
        trees[side] = _paths_as(tree, work, "W")
    assert trees["port"] == trees["jax"]
    assert trees["port"]["train"]["max_epochs"] == epochs
    assert trees["port"]["data"]["valid"]["clean_dir"] == \
        os.path.join("W", "corpus", "test", "clean")


@pytest.mark.usefixtures("both_bundled")
def test_main_runs_the_port_clis(tmp_path, monkeypatch, capsys):
    """The training CLI then metrics_ns, both with `--device`, the noisy
    baseline printed as JAX prints it; metrics_ns's failing code is the
    exit code. Without `--device` the children get none (the card)."""
    lines = {}
    for side, run in (("jax", _run_jax), ("port", _run_port)):
        work = str(tmp_path / side)
        device = ["--device", "cpu"] if side == "port" else []
        fake = FakeRun(0, 5)
        assert run(monkeypatch, ["--workdir", work, "--epochs", "2",
                                 *device], fake) == 5, side
        out = capsys.readouterr().out
        lines[side] = [ln for ln in out.splitlines()
                       if ln.startswith("noisy baseline: ")]
        logs = os.path.join(work, "logs")
        if side == "port":
            assert fake.calls == [
                [sys.executable, "-m", "fastenhancer_tpu_torch.train", "-n",
                 "demo", "-c", os.path.join(work, "demo.yaml"),
                 "--base_dir", logs, "-f", "--device", "cpu"],
                [sys.executable, "-m",
                 "fastenhancer_tpu_torch.scripts.metrics_ns", "-n", "demo",
                 "--base_dir", logs, "--device", "cpu"]]
    assert len(lines["port"]) == 1 and lines["port"] == lines["jax"]

    work = str(tmp_path / "card")
    fake = FakeRun()
    base = _run_port(monkeypatch, ["--workdir", work, "--epochs", "2"], fake)
    assert len(fake.calls) == 2
    assert not any("--device" in c for c in fake.calls)
    assert sorted(base) == ["pesq", "sisdr", "stoi"]
    assert all(np.isfinite(v) for v in base.values())
    assert f"SISDR {base['sisdr']:.2f} dB" in capsys.readouterr().out


@pytest.mark.usefixtures("both_bundled")
def test_a_failing_training_child_ends_the_demo(tmp_path, monkeypatch):
    fake = FakeRun(7)
    assert _run_port(monkeypatch, ["--workdir", str(tmp_path), "--recipe",
                                   "paired", "--device", "cpu"], fake) == 7
    assert len(fake.calls) == 1   # no metrics_ns after it


def test_missing_recording_names_its_path(tmp_path, monkeypatch):
    missing = str(tmp_path / "nowhere.wav")
    monkeypatch.setattr(demo, "BUNDLED", missing)
    with pytest.raises(FileNotFoundError, match="nowhere.wav"):
        demo.build_corpus(str(tmp_path / "w"))
