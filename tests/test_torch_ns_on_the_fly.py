"""The on-the-fly recipe (the DNS and 48 kHz configs) against the JAX
package on the CPU: the dataset, the SNR mixer, the RIR convolution, the
dynamic low-pass, the `ns_on_the_fly` wrapper's mixed batch and train step,
every on-the-fly config, and the training CLI on a tiny on-the-fly corpus.

Tolerances: the dataset and the low-pass kernels bit for bit (the same
host code on the same seeds); the mixer within 1e-6 of the output's peak
(float32, the same operations in the same order); the RIR convolution
within 1e-5 of the peak (two FFT libraries); the low-pass filtering within
1e-6 of the peak; the wrapper's mixed batch within 1e-5 of its peak, and
its float32 train step's losses on JAX's mixed batch within the step
tolerances of tests/_torch_train_parity.py (1e-5 relative, the grad norm
1e-2), on its own within 1e-4.
"""
import os
import random

import numpy as np
import pytest
import torch

from fastenhancer_tpu.data import ns_on_the_fly as jotf
from fastenhancer_tpu.utils.hparams import HParams as JHParams
from fastenhancer_tpu.wrappers import get_wrapper as jget_wrapper
from fastenhancer_tpu_torch.data import get_dataset_dataloader
from fastenhancer_tpu_torch.data import ns_on_the_fly as otf
from fastenhancer_tpu_torch.data.audio_io import write_wav
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.train.__main__ import main as train_main
from fastenhancer_tpu_torch.utils.hparams import HParams, get_hparams
from fastenhancer_tpu_torch.wrappers import get_wrapper
from fastenhancer_tpu_torch.wrappers import ns_on_the_fly as otf_wrapper
from fastenhancer_tpu_torch.wrappers.ns import _copy_into

import _torch_train_parity as tp
from _torch_parity import (TINY_KWARGS, real_triton_only,  # noqa: F401
                           torch_one_thread)

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16_000
SEGMENT = 8000
MIXER_REL = 1e-6
RIR_REL = 1e-5
LPF_REL = 1e-6
BATCH_REL = 1e-5
OWN_BATCH_RTOL = 1e-4
ON_THE_FLY = sorted(
    os.path.join(d, f) for d in ("fastenhancer_dns", "others_dns",
                                 "fastenhancer_48khz")
    for f in os.listdir(os.path.join(REPO, "configs", d)))


def _speech(rng, n, sr=SR):
    """Speech-like: tone bursts with silent stretches."""
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 400) * t)
    x *= (np.sin(2 * np.pi * rng.uniform(2, 4) * t) > -0.3)
    return (x + rng.standard_normal(n) * 0.01).astype(np.float32)


def write_corpus(root, sr=SR, seed=0, rir_dir=False):
    """clean/ (shorter and longer than SEGMENT, one silent), noise/ (one
    silent), rir/ (decaying noise of <= 512 taps); returns their dirs."""
    rng = np.random.default_rng(seed)
    scale = sr // SR
    dirs = {k: os.path.join(str(root), k) for k in ("clean", "noise", "rir")}
    for d in dirs.values():
        os.makedirs(d)
    for i, n in enumerate((3000, 5000, 12000)):
        write_wav(os.path.join(dirs["clean"], f"c{i}.wav"),
                  _speech(rng, n * scale, sr), sr)
    write_wav(os.path.join(dirs["clean"], "silent.wav"),
              np.zeros(6000 * scale, np.float32), sr)
    for i, n in enumerate((4000, 10000)):
        write_wav(os.path.join(dirs["noise"], f"n{i}.wav"),
                  (rng.standard_normal(n * scale) * 0.1).astype(np.float32),
                  sr)
    write_wav(os.path.join(dirs["noise"], "silent.wav"),
              np.zeros(5000 * scale, np.float32), sr)
    if rir_dir:
        for i, n in enumerate((300, 500)):
            r = rng.standard_normal(n) * np.exp(-np.arange(n) / 80.0)
            r[0] = 1.0
            write_wav(os.path.join(dirs["rir"], f"r{i}.wav"),
                      (0.9 * r / np.abs(r).max()).astype(np.float32), sr)
    return dirs


def _write_pairs(root, sr, n=3, seed=4):
    """{root}/clean and {root}/noisy: n paired wavs of 0.5-0.8 s at sr."""
    dirs = [os.path.join(str(root), k) for k in ("clean", "noisy")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        clean = _speech(rng, int(rng.uniform(0.5, 0.8) * sr), sr)
        noisy = clean + (rng.standard_normal(len(clean)) * 0.05).astype(
            np.float32)
        for d, x in zip(dirs, (clean, noisy)):
            write_wav(os.path.join(d, f"{i:03d}.wav"), x, sr)
    return dirs


def _data_cfg(dirs, reverb_prob):
    return {
        "sampling_rate": SR, "silence_length": 0.1,
        "reverb_prob": reverb_prob, "rir_length": 512,
        "snr_mixer": {"segmental_snr": True, "rms_window_size": 0.1,
                      "activity_threshold": -40, "dataloader_rms": -20,
                      "snr_range": [-5, 20], "noisy_rms_range": [-25, -10],
                      "clean_activity_threshold": 0.3,
                      "noise_activity_threshold": 0.0},
        "train": {"clean_dir": dirs["clean"], "noise_dir": dirs["noise"],
                  "rir_dir": dirs["rir"], "segment_size": SEGMENT,
                  "length": 6}}


@pytest.mark.parametrize("reverb_prob", [0.0, 1.0])
def test_dataset_matches_jax_bit_for_bit(tmp_path, reverb_prob):
    """The same seeds give the same items in both packages: clean and
    noise of SEGMENT samples (files shorter than it concatenated with
    silence, longer ones cropped, the silent clean file skipped), the RIR
    (drawn, or the unit impulse at reverb_prob 0), is_reverb and the file
    names; shuffle(seed) orders the file lists alike."""
    dirs = write_corpus(tmp_path, rir_dir=True)
    cfg = _data_cfg(dirs, reverb_prob)
    keys = ["clean", "noise", "rir", "is_reverb", "filename"]
    port = otf.NSOnTheFlyDataset(HParams(**cfg), keys)
    ref = jotf.NSOnTheFlyDataset(JHParams(**cfg), keys)
    assert len(port) == len(ref) == 6
    port.shuffle(5)
    ref.shuffle(5)
    assert port.clean_filelist == ref.clean_filelist
    assert port.noise_filelist == ref.noise_filelist
    items = {}
    for name, ds in (("port", port), ("jax", ref)):
        random.seed(3)
        np.random.seed(3)
        items[name] = [ds[i] for i in range(len(ds))]
    for got, want in zip(items["port"], items["jax"]):
        assert got.keys() == want.keys()
        for k in ("clean", "noise", "rir"):
            assert got[k].dtype == want[k].dtype == np.float32
            assert np.array_equal(got[k], want[k]), k
        assert got["is_reverb"] == want["is_reverb"]
        assert got["filename"] == want["filename"]
        assert got["clean"].shape == got["noise"].shape == (SEGMENT,)
        # reverb_prob 0 leaves the RIR empty (no rir_length is read)
        assert got["rir"].shape == ((512,) if reverb_prob else (0,))
    names = [n for it in items["port"] for n in it["filename"]["clean"]]
    # the branches ran: the silent file drawn (and skipped), an item made
    # of several files (concatenated) and one of the 12000-sample file
    # (cropped)
    assert "silent.wav" in names and "c2.wav" in names
    assert any(len(it["filename"]["clean"]) > 1 for it in items["port"])
    reverb = [it["is_reverb"] for it in items["port"]]
    assert all(reverb) if reverb_prob else not any(reverb)


def _mix_inputs(rows=4, n=8000, seed=1):
    rng = np.random.default_rng(seed)
    clean = np.stack([_speech(rng, n) for _ in range(rows)])
    clean[1] *= 1e-3   # below the -40 dB activity threshold: mask false
    # 2 of the 5 segments of 0.1 s active: the fewest that pass the
    # threshold of 0.3 x 5
    clean[3] = 0.0
    clean[3, :2 * SR // 10] = 0.3 * np.sin(np.arange(2 * SR // 10) * 0.1)
    noise = (rng.standard_normal((rows, n)) * 0.1).astype(np.float32)
    noise[2, ::97] = 0.9   # peaky noise for the clip rescale
    return clean, noise


def _peak_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()), float(
        np.abs(want).max())


@pytest.mark.parametrize("segmental", [True, False])
def test_snr_mixer_matches_jax(segmental):
    """SNRMixer's (clean, noise, noisy) against JAX's within MIXER_REL of
    the peak, in the segmental and the plain SNR branch, at a usual
    rms_target and at 0 dBFS, where the clip rescale engages."""
    import jax.numpy as jnp

    kw = dict(segmental_snr=segmental, activity_threshold=-40,
              dataloader_rms=-20, clean_activity_threshold=0.3)
    port, ref = otf.SNRMixer(SR, **kw), jotf.SNRMixer(SR, **kw)
    clean, noise = _mix_inputs()
    for snr, rms_target in ((5, -25), (-5, 0)):
        got = port(torch.from_numpy(clean), torch.from_numpy(noise), snr,
                   rms_target)
        want = ref(jnp.asarray(clean), jnp.asarray(noise), jnp.float32(snr),
                   jnp.float32(rms_target))
        for g, w in zip(got, want):
            err, peak = _peak_err(g, w)
            assert err <= MIXER_REL * peak, (snr, rms_target, err, peak)


def test_snr_mixer_inactive_row_and_clip():
    """A row whose activity mask is false keeps its noise unscaled (only
    the output normalisation scales it, as it scales clean); at 0 dBFS the
    clip rescale holds every row's peak to the clipping threshold, which
    the -25 dBFS control does not reach."""
    mixer = otf.SNRMixer(SR, segmental_snr=True, activity_threshold=-40,
                         dataloader_rms=-20, clean_activity_threshold=0.3)
    clean, noise = _mix_inputs()
    c, n = torch.from_numpy(clean), torch.from_numpy(noise)
    _, mask = mixer.active_rms(c)
    assert mask[:, 0].tolist() == [True, False, True, True]
    c_out, n_out, _ = mixer(c, n, 5, -25)
    for row, active in ((0, True), (1, False)):
        s_clean = (c_out[row] / c[row]).median()
        s_noise = (n_out[row] / n[row]).median()
        assert torch.isclose(s_noise, s_clean, rtol=1e-5) != active, row
    thr = mixer.clipping_threshold
    peaks = {}
    for target in (-25, 0):
        outs = mixer(c, n, -5, target)
        peaks[target] = torch.stack([o.abs().amax(1) for o in outs]).amax(0)
    assert (peaks[-25] < 0.9 * thr).all()
    assert torch.allclose(peaks[0], torch.full_like(peaks[0], thr),
                          rtol=1e-6)


def test_batch_rir_conv_matches_jax_and_numpy():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    rir = (rng.standard_normal((3, 300)) * np.exp(-np.arange(300) / 60)
           ).astype(np.float32)
    got = otf.batch_rir_conv(torch.from_numpy(x), torch.from_numpy(rir))
    err, peak = _peak_err(got, jotf.batch_rir_conv(jnp.asarray(x),
                                                   jnp.asarray(rir)))
    assert got.dtype == torch.float32 and err <= RIR_REL * peak
    want = np.stack([np.convolve(a, h)[:1000] for a, h in zip(x, rir)])
    err, peak = _peak_err(got, want)
    assert err <= RIR_REL * peak


@pytest.mark.parametrize("p_lpf", [0.0, 0.5])
def test_dynamic_lpf_matches_jax(p_lpf):
    """The kernel bank bit for bit from the same Generator seed (unit
    impulses at p_lpf 0, some low-pass rows at 0.5), and the grouped
    filtering within LPF_REL of the peak."""
    import jax.numpy as jnp

    port = otf.DynamicBatchLPF(48_000, p_lpf=p_lpf)
    ref = jotf.DynamicBatchLPF(48_000, p_lpf=p_lpf)
    kp = port.sample_kernels(6, np.random.default_rng(7))
    kj = ref.sample_kernels(6, np.random.default_rng(7))
    assert kp.dtype == kj.dtype == np.float32 and np.array_equal(kp, kj)
    lowpass = [not np.array_equal(k, port.delta) for k in kp]
    assert any(lowpass) == bool(p_lpf) and not all(lowpass)
    x = np.random.default_rng(8).standard_normal((6, 4800)).astype(
        np.float32)
    got = port(torch.from_numpy(x), kp)
    err, peak = _peak_err(got, ref(jnp.asarray(x), kj))
    assert err <= LPF_REL * peak
    for row, lp in enumerate(lowpass):
        assert torch.equal(got[row], torch.from_numpy(x[row])) != lp


def _recipe(config, dirs, **over):
    """A config's dict with tiny model kwargs, the float32 step, the tiny
    corpus and 2-step warmup."""
    cfg = get_hparams(os.path.join(REPO, "configs", config)).to_dict()
    cfg["model_kwargs"] = dict(TINY_KWARGS)
    cfg["train"].update(fp16=False, batch_size=2)
    cfg["train"]["scheduler_kwargs"]["warmup_iterations"] = 2
    cfg["data"]["train"].update(clean_dir=dirs["clean"],
                                noise_dir=dirs["noise"],
                                rir_dir=dirs["rir"])
    cfg.pop("pesq", None)
    for k, v in over.items():
        cfg["data"][k] = v
    return cfg


def test_wrapper_batch_and_train_step_match_jax(tmp_path):
    """The 48 kHz recipe (dynamic low-pass at p 0.5) with reverb at p 0.5,
    against JAX's wrapper with the same host draws (`random` seeded alike;
    each wrapper's low-pass Generator seeded from train.seed) and the same
    variables: the mixed batch from raw (clean, noise, rir) rows (noise
    shorter than clean, neither a whole number of hops) within BATCH_REL of
    its peak; one float32 train step on JAX's mixed batch within the step
    tolerances; and the step on the port's own mixed batch, whose ~7e-7 of
    the peak from JAX's the model turns into up to 1.1e-5 of a loss
    (wav_l1), within OWN_BATCH_RTOL. JAX's wrapper runs on the tests' 8 CPU
    devices, so the batch has 8 rows and no padding."""
    import jax

    dirs = write_corpus(tmp_path, rir_dir=True)
    cfg = _recipe("fastenhancer_48khz/t.yaml", dirs, reverb_prob=0.5,
                  rir_length=512)
    cfg["base_dir"] = str(tmp_path / "run")
    jw = jget_wrapper("ns_on_the_fly")(JHParams(**cfg), train=True)
    jvars = jax.tree.map(np.asarray, jw.state["variables"])
    pws = []
    for _ in range(2):   # one per step: a step updates the leaves in place
        pw = get_wrapper("ns_on_the_fly")(HParams(**cfg), train=True,
                                          device="cpu")
        for part in ("params", "stats"):
            _copy_into(pw.state["variables"][part], jvars[part], part)
        pws.append(pw)
    assert pw.keys == jw.keys == ["clean", "noise", "noisy", "rir"]
    rows = jw.n_devices
    rng = np.random.default_rng(9)
    batch = {"clean": np.stack([_speech(rng, 48_005) for _ in range(rows)]),
             "noise": (rng.standard_normal((rows, 40_037)) * 0.1).astype(
                 np.float32),
             "rir": np.zeros((rows, 512), np.float32)}
    batch["rir"][:, 0] = 1.0
    batch["rir"][::2, 1:] = (rng.standard_normal((rows // 2, 511)) * 0.05
                             ).astype(np.float32)
    # the control: some rows of this batch are low-passed
    kernels = pw.dynamic_lpf.sample_kernels(rows, np.random.default_rng(
        cfg["train"]["seed"]))
    assert 0 < sum(not np.array_equal(k, pw.dynamic_lpf.delta)
                   for k in kernels) < rows
    random.seed(11)
    jdev, jrows = jw._device_batch(batch, ("clean", "noisy"))
    random.seed(11)
    pdev, prows = pws[0]._device_batch(batch, ("clean", "noisy"))
    assert jrows == prows == rows
    hop = TINY_KWARGS["hop_size"]
    assert pdev["clean"].shape == (rows, 40_037 // hop * hop)
    assert torch.equal(pdev["row_mask"], torch.ones(rows))
    for k in ("clean", "noisy"):
        err, peak = _peak_err(pdev[k], jdev[k])
        assert err <= BATCH_REL * peak, (k, err, peak)
    _, jm = jw.train_step(jw.state, jdev, jw._lrs())
    on_jax_batch = {k: torch.tensor(np.asarray(v))
                    for k, v in jdev.items()}
    for pw, dev_batch, rtol in ((pws[0], pdev, OWN_BATCH_RTOL),
                                (pws[1], on_jax_batch, 1e-5)):
        _, pm = pw.train_step(pw.state, dev_batch, pw._lrs())
        assert {k for k in pm if k.startswith("loss/")} == {
            k for k in jm if k.startswith("loss/")}
        for k in [k for k in pm if k.startswith("loss/")]:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=rtol, err_msg=k)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=tp.GNORM_RTOL)


@pytest.mark.parametrize("config", ON_THE_FLY)
def test_on_the_fly_configs_read_and_build(config, tmp_path):
    """Each of the 17 on-the-fly configs: read by the port's reader, its
    wrapper is the ns_on_the_fly wrapper, and its train dataset builds on a
    tiny corpus at the config's rate and gives items of its segment_size."""
    hps = get_hparams(os.path.join(REPO, "configs", config))
    assert hps.wrapper == "ns_on_the_fly"
    assert get_wrapper(hps.wrapper) is otf_wrapper.ModelWrapper
    sr = hps.data.sampling_rate
    dirs = write_corpus(tmp_path, sr=SR)
    hps.data.train.clean_dir = dirs["clean"]
    hps.data.train.noise_dir = dirs["noise"]
    hps.data.train.length = 2
    ds, loader = get_dataset_dataloader(hps, "train",
                                        ["clean", "noise", "noisy"])
    assert isinstance(ds, otf.NSOnTheFlyDataset) and len(ds) == 2
    assert ds.sr == sr and loader.batch_size == hps.train.batch_size
    random.seed(0)
    item = ds[0]
    seg = hps.data.train.segment_size
    assert item.keys() == {"clean", "noise"}
    assert item["clean"].shape == item["noise"].shape == (seg,)


@pytest.mark.parametrize("config,sr", [("fastenhancer_dns/t.yaml", SR),
                                       ("fastenhancer_48khz/t.yaml", 48_000)])
def test_cli_trains_on_the_fly_and_resumes(config, sr, tmp_path, monkeypatch):
    """`main` with --device cpu on the recipe (tiny model kwargs) over a
    tiny on-the-fly corpus: 2 epochs of 2 steps with valid, PESQ/STOI and a
    checkpoint each, then a resume that runs a third. The 48 kHz recipe's
    low-pass (p 0.5) filters clean and noisy of every train batch; #5's
    plain version runs in the valid and PESQ forwards only."""
    calls = {"scan": 0, "lpf": 0}
    real_scan, real_lpf = scan.gru_scan_reference, otf.DynamicBatchLPF.__call__

    def spy_scan(*a, **kw):
        calls["scan"] += 1
        return real_scan(*a, **kw)

    def spy_lpf(self, *a, **kw):
        calls["lpf"] += 1
        return real_lpf(self, *a, **kw)

    monkeypatch.setattr(scan, "gru_scan_reference", spy_scan)
    monkeypatch.setattr(otf.DynamicBatchLPF, "__call__", spy_lpf)
    dirs = write_corpus(tmp_path / "otf", sr=sr)
    clean, noisy = _write_pairs(tmp_path / "wav", sr)
    logs = str(tmp_path / "logs")
    seg = sr // 2
    params = [f"model_kwargs={TINY_KWARGS!r}",
              f"data.train.clean_dir={dirs['clean']}",
              f"data.train.noise_dir={dirs['noise']}",
              f"data.train.segment_size={seg}", "data.train.length=4",
              f"data.valid.clean_dir={clean}", f"data.valid.noisy_dir={noisy}",
              f"data.valid.segment_size={seg}",
              f"data.pesq.clean_dir={clean}", f"data.pesq.noisy_dir={noisy}",
              "train.batch_size=2", "train.num_workers=1",
              "train.max_epochs=2", "train.save_interval=1",
              "pesq.interval=1", "valid.batch_size=2", "valid.num_workers=1",
              "pesq.batch_size=2"]
    history = train_main(["-n", "run", "-c",
                          os.path.join(REPO, "configs", config),
                          "--base_dir", logs, "--device", "cpu", "-p",
                          *params])
    run = os.path.join(logs, "run")
    assert sorted(os.listdir(run)) == ["00001.ckpt", "00002.ckpt",
                                       "config.yaml", "train", "valid"]
    assert [r["epoch"] for r in history] == [1, 2]
    for r in history:
        assert all(np.isfinite(v) for v in r["train"].values())
        assert all(np.isfinite(v) for v in r["valid"].values())
        assert 1.0 <= r["valid"]["metrics/pesq"] <= 4.65
        assert r["timing"]["steps"] == 2
    blocks = TINY_KWARGS["rnnformer_kwargs"]["num_blocks"]
    # 3 files in batches of 2: 2 valid and 2 PESQ forwards an epoch
    assert calls == {"scan": 2 * blocks * (2 + 2),
                     "lpf": 2 * 2 * 2 if sr == 48_000 else 0}
    calls.update(scan=0, lpf=0)
    history = train_main(["-n", "run", "--base_dir", logs, "--device", "cpu",
                          "-p", "train.max_epochs=3", "-f"])
    assert [r["epoch"] for r in history] == [3]
    assert os.path.exists(os.path.join(run, "00003.ckpt"))
    assert calls == {"scan": blocks * (2 + 2),
                     "lpf": 2 * 2 if sr == 48_000 else 0}
