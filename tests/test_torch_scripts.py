"""The port's entry points on a trained checkpoint against the JAX
package's scripts, on the CPU: `python -m fastenhancer_tpu_torch.scripts.
{enhance,serve,metrics_ns}` (`main(argv)` with --device cpu) against
scripts/{enhance,serve,metrics_ns}.py (`main()` with sys.argv patched, JAX
on the CPU), both on one run directory: a tiny FastEnhancer's JAX
variables (BN statistics perturbed) saved in the JAX checkpoint format,
with the DNS recipe's config.

Tolerances: the written wavs (16-bit PCM) within 1e-4 of the reference's
peak plus one PCM step (a value within float error of a rounding boundary
may land one step apart): `enhance`, `serve` unfused and `--fused` in
float32; `serve --fused --dtype bf16` within BF16_REL of the peak of JAX's
float32 `--fused` output and no farther from it than BF16_VS_JAX x JAX's
own bf16 `--fused` output. The scores that `metrics_ns` prints (4
decimals) within METRIC_TOL.
"""
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from fastenhancer_tpu.models import get_model as jget_model
from fastenhancer_tpu.train.checkpoint import save_checkpoint
from fastenhancer_tpu_torch.data.audio_io import read_wav, write_wav
from fastenhancer_tpu_torch.scripts import enhance, metrics_ns, serve

from _torch_parity import (TINY_KWARGS, perturb_bn_stats,  # noqa: F401
                           torch_one_thread, to_np_tree)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16_000
PCM_STEP = 1 / 32768
WAV_REL = 1e-4
# bfloat16 against float32, of the peak: 2^-5 does not hold at these
# widths for JAX's own bf16 engine (3.2% of the peak on one file), so
# 2^-4, and no farther than BF16_VS_JAX x JAX's own bf16 output
BF16_REL = 2 ** -4
BF16_VS_JAX = 1.5
# printed to 4 decimals: the last printed digit (the port's unrounded
# scores were within 4e-5 of JAX's printed ones)
METRIC_TOL = {"SISDR": 1e-4, "STOI": 1e-4, "ESTOI": 1e-4, "PESQ": 1e-4}


def _speech(rng, n):
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 400) * t)
    x *= (np.sin(2 * np.pi * rng.uniform(2, 4) * t) > -0.3)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(base_dir, run name, noisy dir, clean dir): 3 paired wavs of 0.4-0.9
    s, the config, and 00001.ckpt of JAX variables."""
    import jax

    root = tmp_path_factory.mktemp("scripts")
    dirs = {k: str(root / k) for k in ("clean", "noisy")}
    for d in dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(0)
    for i in range(3):
        clean = _speech(rng, int(rng.uniform(0.4, 0.9) * SR))
        noisy = clean + (rng.standard_normal(len(clean)) * 0.05).astype(
            np.float32)
        for k, x in (("clean", clean), ("noisy", noisy)):
            write_wav(os.path.join(dirs[k], f"{i:03d}.wav"), x, SR)
    with open(os.path.join(REPO, "configs", "fastenhancer_dns",
                           "t.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model_kwargs"] = dict(TINY_KWARGS)
    cfg["data"]["pesq"].update(clean_dir=dirs["clean"],
                               noisy_dir=dirs["noisy"])
    cfg["pesq"].update(batch_size=2, num_workers=0)
    run_dir = root / "logs" / "run"
    os.makedirs(run_dir)
    with open(run_dir / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    jm = jget_model(cfg["model"], **cfg["model_kwargs"])
    jv = perturb_bn_stats(jm.init(jax.random.PRNGKey(3)), seed=4)
    save_checkpoint(str(run_dir), 1, {"variables": to_np_tree(jv)})
    return str(root / "logs"), "run", dirs["noisy"], dirs["clean"]


def _jax_main(module, argv, monkeypatch):
    """scripts/<module>.py's main() with sys.argv patched."""
    import importlib

    monkeypatch.syspath_prepend(REPO)
    mod = importlib.import_module(f"scripts.{module}")
    monkeypatch.setattr(sys, "argv", [f"{module}.py", *argv])
    mod.main()


def _wavs(d):
    return {f: read_wav(os.path.join(d, f))[0] for f in sorted(os.listdir(d))}


def _assert_wavs_close(got_dir, want_dir, rel, pcm=True):
    got, want = _wavs(got_dir), _wavs(want_dir)
    assert got.keys() == want.keys() and len(got) == 3
    for f, w in want.items():
        g = got[f]
        assert g.shape == w.shape and np.isfinite(g).all()
        peak = float(np.abs(w).max())
        assert peak > 0
        err = float(np.abs(g - w).max())
        assert err <= rel * peak + (PCM_STEP if pcm else 0), (f, err, peak)


def test_enhance_matches_jax(run, tmp_path, monkeypatch, capsys):
    base, name, noisy, _ = run
    common = ["-n", name, "--base_dir", base, "-i", noisy,
              "--batch-size", "2"]
    _jax_main("enhance", [*common, "-o", str(tmp_path / "jax")], monkeypatch)
    enhance.main([*common, "-o", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("enhanced 3 files") == 2 and "RTF" in out
    _assert_wavs_close(tmp_path / "port", tmp_path / "jax", WAV_REL)
    # the same lengths as the inputs
    for f, x in _wavs(noisy).items():
        assert len(_wavs(tmp_path / "port")[f]) == len(x)


def test_serve_matches_jax(run, tmp_path, monkeypatch, capsys):
    """Unfused and --fused float32 against JAX's of the same options; the
    fused bfloat16 engine against JAX's fused float32 output. Streams join
    every tick (stagger 1) into 2 slots, so the third waits for a free
    slot."""
    base, name, noisy, _ = run
    common = ["-n", name, "--base_dir", base, "-i", noisy, "--capacity",
              "2", "--stagger", "1"]
    for tag, extra in (("f32", []), ("fused", ["--fused"])):
        _jax_main("serve", [*common, "-o", str(tmp_path / f"jax_{tag}"),
                            *extra], monkeypatch)
        serve.main([*common, "-o", str(tmp_path / f"port_{tag}"),
                    "--device", "cpu", *extra])
        _assert_wavs_close(tmp_path / f"port_{tag}", tmp_path / f"jax_{tag}",
                           WAV_REL)
    bf16 = ["--fused", "--dtype", "bf16"]
    _jax_main("serve", [*common, "-o", str(tmp_path / "jax_bf16"), *bf16],
              monkeypatch)
    serve.main([*common, "-o", str(tmp_path / "port_bf16"), "--device",
                "cpu", *bf16])
    _assert_wavs_close(tmp_path / "port_bf16", tmp_path / "jax_fused",
                       BF16_REL, pcm=False)
    # the control: JAX's own bf16 engine is as far from its float32 one
    want, ref = _wavs(tmp_path / "jax_fused"), _wavs(tmp_path / "jax_bf16")
    for f, g in _wavs(tmp_path / "port_bf16").items():
        assert (np.abs(g - want[f]).max()
                <= BF16_VS_JAX * np.abs(ref[f] - want[f]).max()), f
    out = capsys.readouterr().out
    assert out.count("served 3 streams") == 6
    assert out.count("tick latency ms: p50") == 6
    for f, x in _wavs(noisy).items():
        assert len(_wavs(tmp_path / "port_bf16")[f]) == len(x)


def _scores(text):
    out = {}
    for line in text.splitlines():
        key, sep, val = line.strip().partition(":")
        if sep and key in METRIC_TOL:
            out[key] = float(val.split()[0])
    return out


def test_metrics_ns_matches_jax(run, monkeypatch, capsys):
    base, name, _, _ = run
    _jax_main("metrics_ns", ["-n", name, "--base_dir", base,
                             "--no-external"], monkeypatch)
    want = _scores(capsys.readouterr().out)
    got = metrics_ns.main(["-n", name, "--base_dir", base, "--device",
                           "cpu", "--no-external"])
    printed = _scores(capsys.readouterr().out)
    assert printed.keys() == want.keys() == set(METRIC_TOL)
    assert {k.upper() for k in got} == set(METRIC_TOL)
    for k, tol in METRIC_TOL.items():
        assert np.isfinite(printed[k])
        assert abs(printed[k] - want[k]) <= tol, (k, printed[k], want[k])
        assert abs(got[k.lower()] - printed[k]) <= 5e-5
    assert 1.0 <= printed["PESQ"] <= 4.65 and 0 <= printed["STOI"] <= 1
    # without --no-external: one "skipped" line each, as JAX prints them
    # without their backends; --wer raises
    metrics_ns.main(["-n", name, "--base_dir", base, "--device", "cpu",
                     "--max-items", "1"])
    out = capsys.readouterr().out
    assert "DNSMOS skipped" in out and "SCOREQ skipped" in out
    with pytest.raises(ImportError, match="WER"):
        metrics_ns.main(["-n", name, "--base_dir", base, "--device", "cpu",
                         "--wer"])


@pytest.mark.parametrize("script", [enhance, serve, metrics_ns])
def test_scripts_need_a_card_unless_told_otherwise(run, tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    base, name, noisy, _ = run
    argv = ["-n", name, "--base_dir", base]
    if script is not metrics_ns:
        argv += ["-i", noisy, "-o", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)
    assert not os.path.exists(tmp_path / "out")
