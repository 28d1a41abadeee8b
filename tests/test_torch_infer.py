"""The showcase inference and the rest of the training CLI's summaries on
the CPU, against the JAX package: the `infer` loader mode (file order,
bucket padding, wav_len), `ModelWrapper.infer_epoch` on shared weights
(audio and spectrogram magnitudes within 1e-5 of the peak, infer/sisdr
within 1e-3 dB; on JAX's own enhanced audio, log-spectrograms within
1e-4 plus a float32 FFT's noise in weak bins; noisy and clean audio only while epoch <= infer.interval; #5's
plain version, what a CPU tensor runs, once a block a file), and a CLI run
(`--device cpu`, 2 epochs, infer.interval=1, plot_param_and_grad) whose
event files hold the tags JAX's wrapper gives for the same config."""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from fastenhancer_tpu.data import get_dataset_dataloader as jax_loader
from fastenhancer_tpu.utils.hparams import HParams as JHParams
from fastenhancer_tpu.utils.hparams import get_hparams as jax_get_hparams
from fastenhancer_tpu.utils.summarize import (
    plot_param_and_grad as jax_plot_param_and_grad)
from fastenhancer_tpu.wrappers import get_wrapper as jax_get_wrapper
from fastenhancer_tpu_torch.data import get_dataset_dataloader
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.train.__main__ import main
from fastenhancer_tpu_torch.utils.event_file import read_events
from fastenhancer_tpu_torch.utils.hparams import HParams
from fastenhancer_tpu_torch.wrappers import get_wrapper

from _torch_parity import (TINY_KWARGS, perturb_bn_stats,  # noqa: F401
                           port_variables, real_triton_only, to_np_tree,
                           write_shard_dir, write_wav_pairs,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fastenhancer_shard", "t.yaml")
HOP = TINY_KWARGS["hop_size"]
FILES = ["000", "003"]  # not in length order


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    return write_wav_pairs(root, seed=4, n=5, dur=(1.0, 2.0))


def _config(wavs, root, interval=1):
    clean, noisy = wavs
    return dict(
        model="fastenhancer.default", model_kwargs=TINY_KWARGS, wrapper="ns",
        base_dir=str(root),
        data=dict(dataset="NoiseSuppression", sampling_rate=16_000,
                  infer=dict(clean_dir=clean, noisy_dir=noisy,
                             files=list(FILES))),
        train=dict(batch_size=2), infer=dict(batch_size=1, interval=interval))


def test_infer_loader_matches_jax(wavs, tmp_path):
    cfg = _config(wavs, tmp_path)
    keys = ["clean", "noisy", "wav_len"]
    _, tl = get_dataset_dataloader(HParams(**cfg), "infer", keys)
    _, jl = jax_loader(JHParams(**cfg), "infer", keys)
    tb, jb = list(tl), list(jl)
    assert len(tb) == len(jb) == len(FILES)
    lengths = []
    for t, j in zip(tb, jb):
        assert sorted(t) == sorted(j) == sorted(keys)
        for k in keys:
            np.testing.assert_array_equal(t[k], j[k])
        assert t["noisy"].shape[-1] % (16 * HOP) == 0
        assert t["noisy"].shape[-1] - int(t["wav_len"][0]) < 16 * HOP
        lengths.append(int(t["wav_len"][0]))
    assert lengths == sorted(lengths)  # the files come by duration


@pytest.fixture(scope="module")
def jax_showcase(wavs, tmp_path_factory):
    """JAX's ns wrapper on the tiny model (BN statistics drawn away from
    their init) and its infer loader, shared so that its jitted forward
    compiles once for the file: (wrapper, loader, config)."""
    cfg = _config(wavs, tmp_path_factory.mktemp("jax"))
    jw = jax_get_wrapper("ns")(JHParams(**cfg), train=False)
    init = perturb_bn_stats(to_np_tree(jw.state["variables"]), 3)
    jw.state["variables"] = jax.tree.map(jnp.asarray, init)
    return jw, jax_loader(JHParams(**cfg), "infer", jw.infer_keys)[1], cfg


def _assert_log_close(got, want, what):
    """log10(mag + 1e-5) within 1e-4, plus what a float32 FFT's error of
    1e-6 of the peak magnitude becomes in the log of a weak bin (the two
    packages' FFTs differ by that much: 2e-4 in log10 at a bin 1e-4 of the
    peak, measured)."""
    mag = 10.0 ** np.asarray(want, np.float64)
    tol = 1e-4 + 1e-6 * mag.max() / (mag * np.log(10.0))
    err = np.abs(np.asarray(got, np.float64) - want)
    assert got.shape == want.shape and (err <= tol).all(), (
        what, float(err.max()), float((err - tol).max()))


def test_infer_epoch_matches_jax(jax_showcase, monkeypatch):
    jw, jloader, cfg = jax_showcase
    tw = get_wrapper("ns")(HParams(**cfg), train=False, device="cpu")
    tw.state["variables"] = port_variables(jw.state["variables"])

    def tloader():
        return get_dataset_dataloader(HParams(**cfg), "infer",
                                      tw.infer_keys)[1]
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    plain = scan.gru_scan_reference
    monkeypatch.setattr(scan, "gru_scan_reference", spy)
    for epoch in (1, 2):
        jw.epoch = tw.epoch = epoch
        js, ts = jw.infer_epoch(jloader), tw.infer_epoch(tloader())
        names = [f"{i:02d}" for i in range(len(FILES))]
        want = {f"enhanced/{n}" for n in names}
        if epoch == 1:
            want |= {f"{k}/{n}" for k in ("noisy", "clean") for n in names}
        assert set(ts["audios"]) == set(js["audios"]) == want
        assert set(ts["specs"]) == set(js["specs"]) == {
            f"{k}/{n}" for k in ("enhanced", "enhanced_mel") for n in names}
        for k, v in js["audios"].items():
            v = np.asarray(v)
            assert ts["audios"][k].shape == v.shape
            np.testing.assert_allclose(ts["audios"][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)
        for k, v in js["specs"].items():
            # the port's audio is JAX's within float32 noise; log10 of a
            # weak bin magnifies that noise, so here the magnitudes are
            # held to 1e-5 of their peak, as the audio is
            assert ts["specs"][k].shape == np.shape(v)
            mag, want = 10.0 ** ts["specs"][k], 10.0 ** np.asarray(v, float)
            np.testing.assert_allclose(mag, want, rtol=0,
                                       atol=1e-5 * want.max(), err_msg=k)
        assert abs(ts["scalars"]["infer/sisdr"]
                   - js["scalars"]["infer/sisdr"]) < 1e-3
        # on JAX's own enhanced audio, the port's summaries are JAX's:
        # log-spectrograms within 1e-4 (and the float32 FFT's noise in
        # weak bins), the audio bit for bit
        port_fn = tw.infer_fn
        tw.infer_fn = lambda v, noisy: torch.from_numpy(np.array(
            jw.infer_fn(jw.state["variables"], jnp.asarray(noisy.numpy()))))
        same = tw.infer_epoch(tloader())
        tw.infer_fn = port_fn
        for k, v in js["audios"].items():
            np.testing.assert_array_equal(same["audios"][k], np.asarray(v))
        for k, v in js["specs"].items():
            _assert_log_close(same["specs"][k], np.asarray(v), k)
        assert abs(same["scalars"]["infer/sisdr"]
                   - js["scalars"]["infer/sisdr"]) < 1e-3
    blocks = TINY_KWARGS["rnnformer_kwargs"]["num_blocks"]
    assert len(calls) == 2 * len(FILES) * blocks


def _cli_params(root, clean, noisy):
    speech = write_shard_dir(root, "speech", seed=1, dur=(1.0, 2.0))
    noise = write_shard_dir(root, "noise", seed=2, dur=(1.0, 2.0))
    inputs = {"speech": [{"shard_dir": speech}],
              "noise": [{"shard_dir": noise}]}
    return [f"model_kwargs={TINY_KWARGS!r}",
            f"data.train.inputs={inputs!r}", "data.train.num_workers=1",
            "data.max_duration=6", f"data.valid.clean_dir={clean}",
            f"data.valid.noisy_dir={noisy}", f"data.pesq.clean_dir={clean}",
            f"data.pesq.noisy_dir={noisy}", f"data.infer.clean_dir={clean}",
            f"data.infer.noisy_dir={noisy}", f"data.infer.files={FILES!r}",
            "train.steps_per_epoch=1", "train.max_epochs=2",
            "train.save_interval=2", "pesq.interval=3", "infer.interval=1",
            "train.plot_param_and_grad=True", "valid.batch_size=5",
            "valid.num_workers=1", "pesq.batch_size=5"]


def _jax_tags(params, root, jax_showcase):
    """The tags of each epoch's summaries as JAX's wrapper and train.py
    make them for the same config: the train summary's (a `loss/` tag for
    each of the config's losses, `lr`, and plot_param_and_grad of the
    tiny model's params and of a gradient tree, which is the params'
    tree), the valid losses' and those of JAX's own infer_epoch on the
    same files at the same infer.interval (run for each epoch)."""
    hps = jax_get_hparams(CONFIG, str(root / "jax"), save=False,
                          params=params)
    w, infer_loader, cfg = jax_showcase
    assert cfg["infer"]["interval"] == hps.infer.interval
    assert cfg["data"]["infer"]["files"] == list(hps.data.infer.files)
    hists = {}
    jax_plot_param_and_grad(hists, w.state["variables"]["params"],
                            grads=w.state["variables"]["params"])
    losses = {f"loss/{n}" for n in hps.train.losses.keys()}
    tags = {}
    for epoch in (1, 2):
        w.epoch = epoch
        i = w.infer_epoch(infer_loader)
        tags[epoch] = (losses | {"lr"} | set(hists),
                       losses | set(i["scalars"]) | set(i["audios"])
                       | set(i["specs"]))
    return tags


def test_cli_writes_jax_summary_tags(wavs, jax_showcase, tmp_path,
                                     capsys, monkeypatch):
    params = _cli_params(tmp_path, *wavs)
    logs = tmp_path / "logs"
    history = main(["-n", "run", "-c", CONFIG, "--base_dir", str(logs),
                    "--device", "cpu", "-p", *params])
    out = capsys.readouterr().out
    assert "rank 0 of 1, device: cpu" in out and "not ported" not in out
    assert "Epoch 1 - Train 1/1 (100.0%)" in out
    assert [sorted(r["infer"]) for r in history] == [["infer/sisdr"]] * 2
    assert all({"summarize", "infer"} <= set(r["timing"]) for r in history)
    run = logs / "run"
    assert sorted(os.listdir(run)) == ["00002.ckpt", "config.yaml", "train",
                                       "valid"]
    want = _jax_tags(params, tmp_path, jax_showcase)
    for part, i in (("train", 0), ("valid", 1)):
        (name,) = os.listdir(run / part)
        events = read_events(str(run / part / name))
        got = {e: {t for ev in events if ev["step"] == e
                   for t, _, _ in ev["values"]} for e in (1, 2)}
        assert got == {e: want[e][i] for e in (1, 2)}, part
        # tensorboard's reader on its own record reader (its TF stub, which
        # checks the CRCs too): importing TensorFlow, where it is
        # installed, takes longer than the rest of the test
        monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                            types.ModuleType("tensorboard.compat.notf"))
        acc = EventAccumulator(str(run / part),
                               size_guidance={"audio": 0, "images": 0})
        acc.Reload()
        found = acc.Tags()
        assert set(found["scalars"]) == {
            t for t in want[1][i] | want[2][i]
            if t.split("/")[0] in ("loss", "lr", "metrics", "infer")}
        if part == "train":
            assert set(found["histograms"]) == {
                t for t in want[1][0] if t.split("/")[0] in ("param", "grad")}
        else:
            assert set(found["audio"]) == {
                t for t in want[1][1] if t.split("/")[0] in
                ("noisy", "clean", "enhanced")}
            assert set(found["images"]) == {
                t for t in want[1][1] if t.startswith("enhanced")}
            # noisy and clean audio only while epoch <= infer.interval
            assert {e.step for e in acc.Audio("noisy/00")} == {1}
            assert {e.step for e in acc.Audio("enhanced/00")} == {1, 2}
