"""The port's export path on the CPU: the folded streaming step as a
`torch.export` program (fastenhancer_tpu_torch/scripts/export.py) and the
model-free runner (scripts/run_exported.py), against the JAX package.

* Parity: the tiny FastEnhancer (wav2wav and spec2spec, unfused and
  fused), dptransformer, BSRNN and dprnn (fused) with JAX weights moved
  across by the bridge; the port's program is exported, saved, loaded and
  run over 6 seeded hops against JAX's `streaming_step`,
  `streaming_step_fused` and spec2spec step (its Pallas kernels as the
  other port tests run them on the CPU). Outputs and carries within 1e-5
  of each one's peak (float32). The export runs with every kernel's plain
  version made to raise: the program holds one `fastenhancer::*` node per
  kernel launch and nothing of the plain version.
* The STFT constants' cache: two exports of a fresh model in one process,
  then an eager step equal to one taken before any export.
* The CLI: `export.main` on a run written untrained by the port's wrapper,
  then the runner in a subprocess that must not load the models, the
  wrappers or the trainer; wav2wav against spec2spec (after the
  n_fft - hop delay) above 40 dB, spec2spec --fused against unfused above
  80 dB (tests/test_data_and_training.py's bounds), the time_kernel
  --fused export on a wav the test writes, and the spec2spec --fused gate
  refusing dptransformer and BSRNN by their class attribute.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from fastenhancer_tpu.models import get_model as jget_model
from fastenhancer_tpu_torch.data.audio_io import read_wav, write_wav
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.ops import (bsrnn_stack, dprnn_stack, dpt_stack,
                                        fused_frame, rnnformer_stack)
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.scripts import export

from _torch_parity import (TINY_KWARGS, flatten_paths, one_thread_env,
                           perturb_bn_stats, port_variables,
                           real_triton_only,  # noqa: F401
                           to_np_tree, torch_one_thread)
from test_model_variants import DPRNN_KWARGS

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HOPS = 2, 6
REL = 1e-5
FAMILIES = {
    "fe": ("fastenhancer.default", dict(TINY_KWARGS, stft_method="matmul")),
    # tests/test_torch_dpt.py's model: the pointer wraps at hop 5
    "dpt": ("fastenhancer.dptransformer", dict(
        channels=12, kernel_size=[4, 3], stride=4,
        dpt_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                        lookbehind=5, positional_embedding="train"),
        n_fft=128, hop_size=64, win_size=128, window="hann",
        weight_norm=True, pre_post_init="linear_fixed",
        stft_method="matmul")),
    "bsrnn": ("bsrnn", dict(num_channels=8, num_layers=2,
                            stft_method="matmul")),
    "dprnn": ("fastenhancer.dprnn", dict(DPRNN_KWARGS, stft_method="matmul")),
}
NB = TINY_KWARGS["rnnformer_kwargs"]["num_blocks"]
# (family, spec2spec, fused) -> the program's kernel nodes
FORMS = {
    ("fe", False, False): ["fastenhancer::gru_scan"] * NB,
    ("fe", False, True): ["fastenhancer::rnnformer_stack"],
    ("fe", True, False): ["fastenhancer::gru_scan"] * NB,
    ("fe", True, True): ["fastenhancer::rnnformer_stack"],
    ("dpt", False, True): ["fastenhancer::dpt_stack"],
    ("bsrnn", False, True): ["fastenhancer::bsrnn_stack"],
    ("dprnn", False, True): ["fastenhancer::dprnn_stack"],
}
PLAIN = [(rnnformer_stack, "rnnformer_stack_reference"),
         (fused_frame, "fused_frame_reference"),
         (dpt_stack, "dpt_stack_reference"),
         (bsrnn_stack, "bsrnn_stack_reference"),
         (dprnn_stack, "dprnn_stack_reference"),
         (scan, "gru_scan_reference")]


@functools.lru_cache(maxsize=None)
def _family(fam):
    """(JAX model, port model, JAX folded variables, the port's copy)."""
    name, kw = FAMILIES[fam]
    jm, tm = jget_model(name, **kw), get_model(name, **kw)
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(7)), 7))
    jf = jm.fold(jv)
    return jm, tm, jf, port_variables(jf)


def _jax_step(jm, jf, spec2spec, fused):
    """JAX's step of the form and its initial carry."""
    plan = jm.build_stack_plan(jf) if fused else None
    if spec2spec:
        def step(carry, spec):
            if fused:
                mask, h = jm.model_forward_fused(jf, plan, spec, carry["h"])
            else:
                mask, h, _ = jm.model_forward(jf["params"], jf["stats"],
                                              spec, h0=carry["h"])
            return dict(carry, h=h), jm.complex_mask_mul(spec, mask)
    elif fused:
        def step(carry, hop):
            return jm.streaming_step_fused(jf, plan, carry, hop)
    else:
        def step(carry, hop):
            return jm.streaming_step(jf, carry, hop)
    return jax.jit(step), jm.init_streaming_carry(B, fused=fused)


def _assert_close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= REL * peak, (what, err, peak)


@pytest.mark.parametrize("form", list(FORMS), ids=[
    f"{f}-{'s2s' if s else 'w2w'}{'-fused' if u else ''}"
    for f, s, u in FORMS])
def test_exported_step_matches_jax(form, tmp_path, monkeypatch):
    fam, spec2spec, fused = form
    jm, tm, jf, tf = _family(fam)
    step, carry0, feed = export.make_step(tm, tf, B, torch.device("cpu"),
                                          spec2spec, fused)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's plain version ran while tracing")

    with monkeypatch.context() as m:
        for module, name in PLAIN:
            m.setattr(module, name, refuse)
        program = torch.export.export(export.StepModule(step),
                                      (tf, carry0, feed))
    assert export.kernel_nodes(program) == FORMS[form]
    if fam == "dpt":
        # the op writes the caches in place; the functional form lists them
        mutated = program.run_decompositions().graph_signature
        assert sorted(mutated.user_inputs_to_mutate.values()) == [
            "carry_kc", "carry_vc"]
    path = str(tmp_path / "step.pt2")
    torch.export.save(program, path)
    run = torch.export.load(path).module()

    jstep, cj = _jax_step(jm, jf, spec2spec, fused)
    rng = np.random.default_rng(11)
    feeds = (rng.standard_normal((HOPS,) + tuple(feed.shape)) * 0.3
             ).astype(np.float32)
    ct = export.clone_tree(carry0)
    ys_t, ys_j = [], []
    with torch.no_grad():
        for x in feeds:
            ct, yt = run(tf, ct, torch.from_numpy(x))
            cj, yj = jstep(cj, jnp.asarray(x))
            ys_t.append(yt.numpy())
            ys_j.append(np.asarray(yj))
    _assert_close(ys_t, ys_j, "output")
    got = flatten_paths(ct)
    want = flatten_paths(to_np_tree(cj))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key].numpy()
        if fam == "dpt" and key[0] in ("kc", "vc"):
            nb, b, lb, f, c = g.shape   # JAX: [NB, L, C, B * F'], F' >= F
            w = w.reshape(nb, lb, c, b, -1)[..., :f].transpose(0, 3, 1, 4, 2)
        if key == ("ptr",):
            lb = FAMILIES["dpt"][1]["dpt_kwargs"]["lookbehind"]
            assert int(g) == int(w) == HOPS % lb
            continue
        _assert_close(g, w, key)


def test_two_exports_leave_the_eager_step_alone():
    """A fresh model exported twice in one process, then stepped eagerly,
    gives the eager step of a model no trace has touched: no fake tensor
    stays in the STFT constants' cache."""
    name, kw = FAMILIES["fe"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, kw["hop_size"])
                                             ).astype(np.float32))
    outs = []
    for traced in (False, True):
        model = get_model(name, **kw)
        folded = model.fold(model.init(torch.Generator().manual_seed(1),
                                       "cpu"))
        step, carry0, feed = export.make_step(model, folded, B,
                                              torch.device("cpu"))
        if traced:
            for _ in range(2):
                torch.export.export(export.StepModule(step),
                                    (folded, carry0, feed))
            cached = model.stft_cfg.__dict__.get("_tensors", {}).values()
            assert all(type(t) is torch.Tensor for t in cached)
        with torch.no_grad():
            _, y = step(folded, export.clone_tree(carry0), x)
        assert type(y) is torch.Tensor
        outs.append(y)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


# -- the CLI -------------------------------------------------------------

SR = 16_000
# one intra-op thread, as the test process runs (the suite runs six
# xdist workers on eight cores)
RUNNER = """
import sys
import torch
torch.set_num_threads(1)
from fastenhancer_tpu_torch.scripts import run_exported
for art, out in zip(sys.argv[1::2], sys.argv[2::2]):
    run_exported.main([art, "--params", art + ".params.pkl", "-i", {wav!r},
                       "-o", out, "--device", "cpu"])
loaded = sorted(m for m in sys.modules if m.split(".")[:2] in (
    ["fastenhancer_tpu_torch", "models"], ["fastenhancer_tpu_torch",
    "wrappers"], ["fastenhancer_tpu_torch", "train"]) or m == "jax")
assert not loaded, loaded
"""


def _write_run(root, name, config, model_kwargs):
    """An untrained checkpoint of the port's wrapper in root/logs/name."""
    from fastenhancer_tpu_torch.utils.hparams import get_hparams
    from fastenhancer_tpu_torch.wrappers import get_wrapper

    with open(os.path.join(REPO, "configs", config)) as f:
        cfg = yaml.safe_load(f)
    cfg["model_kwargs"] = model_kwargs
    run = root / "logs" / name
    run.mkdir(parents=True)
    with open(run / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    hps = get_hparams(None, base_dir=str(run))
    get_wrapper(hps.wrapper)(hps, train=False, device="cpu").save(1)
    return str(root / "logs")


def _snr(ref, x):
    err = np.mean((ref - x) ** 2)
    return 10 * np.log10(max(np.mean(ref ** 2), 1e-20) / max(err, 1e-20))


def test_cli_export_and_model_free_runner(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(export, "SLOPE_FRAMES", (2, 4))
    tk = yaml.safe_load(open(os.path.join(
        REPO, "configs", "ablation", "time_kernel_b.yaml")))["model_kwargs"]
    tk.update(channels=8, kernel_size_freq=[4, 3])
    tk["rnnformer_kwargs"].update(num_blocks=1, channels=8, freq=8,
                                  num_heads=2)
    base = _write_run(tmp_path, "fe", "fastenhancer_dns/t.yaml",
                      dict(TINY_KWARGS))
    _write_run(tmp_path, "tk", "ablation/time_kernel_b.yaml", tk)
    rng = np.random.default_rng(0)
    t = np.arange(SR // 2) / SR
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
           + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    wav_path = str(tmp_path / "in.wav")
    write_wav(wav_path, wav, SR)

    arts = {}
    for tag, name, extra in (("w2w", "fe", []),
                             ("s2s", "fe", ["--spec2spec"]),
                             ("s2sf", "fe", ["--spec2spec", "--fused"]),
                             ("tk", "tk", ["--fused", "--streams", "2"])):
        art = str(tmp_path / f"{tag}.pt2")
        export.main(["-n", name, "--base_dir", base, "--device", "cpu",
                     "--save", art, "--seconds", "0.05", *extra])
        out = capsys.readouterr().out
        assert "streaming step" in out and "per-tick slope" in out, out
        arts[tag] = art
    argv = []
    for tag, art in arts.items():
        argv += [art, str(tmp_path / f"out_{tag}.wav")]
    r = subprocess.run(
        [sys.executable, "-c", RUNNER.format(wav=wav_path), *argv],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=one_thread_env(PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("per-tick latency ms") == len(arts), r.stdout
    assert r.stdout.count("amortized (pipelined dispatch)") == len(arts)

    outs = {tag: read_wav(str(tmp_path / f"out_{tag}.wav"))[0]
            for tag in arts}
    delay = TINY_KWARGS["n_fft"] - TINY_KWARGS["hop_size"]
    a, s = outs["w2w"][delay:], outs["s2s"]
    n = min(len(a), len(s)) - 512
    assert _snr(s[512:n], a[512:n]) > 40
    n = min(len(s), len(outs["s2sf"]))
    assert _snr(s[:n], outs["s2sf"][:n]) > 80
    assert len(outs["tk"]) and np.isfinite(outs["tk"]).all()


@pytest.mark.parametrize("fam", ["dpt", "bsrnn"])
def test_spec2spec_fused_gate_by_class_attribute(fam, tmp_path, capsys):
    name, kw = FAMILIES[fam]
    assert type(get_model(name, **kw)).spec2spec_fused is False
    config = {"dpt": "ablation/dpt_b.yaml",
              "bsrnn": "others_dns/bsrnn_xt.yaml"}
    base = _write_run(tmp_path, fam, config[fam], kw)
    with pytest.raises(SystemExit):
        export.main(["-n", fam, "--base_dir", base, "--device", "cpu",
                     "--spec2spec", "--fused"])
    assert "single-carry" in capsys.readouterr().err
    for single in ("fastenhancer.default", "fastenhancer.conv_stft",
                   "fastenhancer.ln", "fastenhancer.time_kernel",
                   "fastenhancer.dprnn"):
        from fastenhancer_tpu_torch.models import get_model_class
        assert get_model_class(single).spec2spec_fused is True
