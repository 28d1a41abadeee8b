"""The port's entry points compute float32 in full float32, its train step
gives the same gradients every run, and the last public names of the JAX
package's losses and terminal helpers have their counterparts.

- Every entry point's `main` turns TF32 off for products and
  convolutions before it reads its arguments, so `--help` already leaves
  both flags False (PyTorch's default for convolutions is True).
- FE-T's train step at the test widths, run twice from one seed on one
  batch, gives bit-equal gradients (the JAX package's step does).
- FSPEN's bfloat16 convolutions sum in float32: with a convolution that
  rounds its bf16 sum before the bias, as cuDNN's does, in place of
  PyTorch's, FSPEN's bf16 chunked stream gives the same bits. Each bf16
  parameter's float32 copy is made once and made again after an in-place
  update.
- `losses.{si_snr,wav_l1,mag_mse,complex_mse,phase}_loss`,
  `Losses.print` and `utils.terminal.{clear_previous_line,progress}`
  against the JAX package's on the same inputs (float32, rtol 1e-5; the
  printed strings exactly).
"""
import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastenhancer_tpu import losses as jlosses
from fastenhancer_tpu.utils import terminal as jterminal
from fastenhancer_tpu_torch import losses as tlosses
from fastenhancer_tpu_torch.models import fspen as fspen_module
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer.default import Model
from fastenhancer_tpu_torch.optim import get_optimizer
from fastenhancer_tpu_torch.presets import FE_T_SHARD
from fastenhancer_tpu_torch.train import make_train_step
from fastenhancer_tpu_torch.utils import (cast_floating, tree_map,
                                          tree_paths)
from fastenhancer_tpu_torch.utils import terminal as tterminal

from _torch_parity import (TINY_KWARGS, real_triton_only,  # noqa: F401
                           torch_one_thread)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ENTRY_POINTS = ["fastenhancer_tpu_torch.train.__main__",
                "fastenhancer_tpu_torch.scripts.serve",
                "fastenhancer_tpu_torch.scripts.enhance",
                "fastenhancer_tpu_torch.scripts.metrics_ns",
                "fastenhancer_tpu_torch.scripts.export",
                "fastenhancer_tpu_torch.scripts.run_exported",
                "fastenhancer_tpu_torch.scripts.train_demo"]


@pytest.fixture
def tf32_on():
    """Both TF32 flags True for the test, restored after it."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    yield
    for f, v in zip(flags, saved):
        f.allow_tf32 = v


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_turn_tf32_off_first(module, tf32_on, capsys):
    main = importlib.import_module(module).main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.usefixtures("real_triton_only", "torch_one_thread")
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_gradients_are_reproducible(remat):
    """Two bf16 steps of FE-T (the shard recipe's train section, the test
    widths) from one seed on one batch: every gradient leaf bit-equal."""
    hp = copy.deepcopy(FE_T_SHARD["train"])
    hp["losses"]["consistency"].update(
        n_fft=TINY_KWARGS["n_fft"], hop_size=TINY_KWARGS["hop_size"],
        win_size=TINY_KWARGS["win_size"], win_type="hann")
    rng = np.random.default_rng(3)
    n = TINY_KWARGS["hop_size"] * 16
    clean = (rng.standard_normal((3, n)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal(clean.shape) * 0.05).astype(
        np.float32)
    batch = {"clean": torch.from_numpy(clean),
             "noisy": torch.from_numpy(noisy),
             "row_mask": torch.tensor([1.0, 1.0, 0.0])}

    def grads():
        model = Model(**TINY_KWARGS)
        model.remat = remat
        variables = model.init(torch.Generator().manual_seed(0), "cpu")
        opt = get_optimizer(model, variables["params"], hp)
        step = make_train_step(model, tlosses.Losses(hp["losses"]), opt,
                               compute_dtype=torch.bfloat16,
                               return_grads=True)
        _, m = step({"variables": variables}, batch, [1e-3] * opt.n_groups)
        return tree_paths(m["grads"])

    first, second = grads(), grads()
    assert [p for p, _ in first] == [p for p, _ in second]
    differ = [p for (p, a), (_, b) in zip(first, second)
              if not torch.equal(a, b)]
    assert not differ, f"gradients differ run to run: {differ}"
    assert any(bool(g.abs().sum() > 0) for _, g in first)


def _rounded_before_bias(conv):
    """conv as cuDNN computes it in bfloat16: the sum rounded to bf16,
    then the bias added in bf16."""
    def call(x, w, b=None, *args, **kwargs):
        if x.dtype != torch.bfloat16 or b is None:
            return conv(x, w, b, *args, **kwargs)
        s = conv(x.float(), w.float(), None, *args, **kwargs)
        return s.to(torch.bfloat16) + b[:, None]
    return call


def test_fspen_bf16_convs_sum_in_float32(monkeypatch):
    """FSPEN at the test widths, bf16, 4 streams in chunks of 4 with BN
    folded in: the stream is bit for bit the same whether a bf16
    convolution rounds its sum before its bias or not, because FSPEN runs
    each one on float32 values (on the H100, cuDNN's rounding takes the
    bf16 stream's error past 1.5x the CPU's: chip_smoke.py phase 19)."""
    model = get_model("fspen", channels=[4, 8, 16], stft_method="matmul",
                      dpe_kwargs=dict(num_blocks=1, channels=8, groups=2))
    folded = cast_floating(model.fold(model.init(
        torch.Generator().manual_seed(0), "cpu")), torch.bfloat16)
    rng = np.random.default_rng(7)
    wav = torch.from_numpy((rng.standard_normal((4, 256 * 16)) * 0.3)
                           .astype(np.float32)).to(torch.bfloat16)
    want = model.stream(folded, wav, chunk_frames=4)
    for name in ("conv1d", "conv_transpose1d"):
        monkeypatch.setattr(F, name, _rounded_before_bias(getattr(F, name)))
    got = model.stream(folded, wav, chunk_frames=4)
    assert torch.isfinite(want.float()).all()
    assert torch.equal(got, want)


def test_fspen_float32_copies_follow_in_place_updates():
    """FSPEN's bf16 convolutions widen each parameter once and reuse the
    copy while the parameter is unchanged; after an in-place update of a
    weight the stream is the one a fresh copy of the tree gives."""
    model = get_model("fspen", channels=[4, 8, 16], stft_method="matmul",
                      dpe_kwargs=dict(num_blocks=1, channels=8, groups=2))
    folded = cast_floating(model.fold(model.init(
        torch.Generator().manual_seed(0), "cpu")), torch.bfloat16)
    rng = np.random.default_rng(8)
    wav = torch.from_numpy((rng.standard_normal((2, 256 * 8)) * 0.3)
                           .astype(np.float32)).to(torch.bfloat16)
    first = model.stream(folded, wav, chunk_frames=4)
    weight = folded["params"]["fullband_encoder"][0]["conv"]["weight"]
    assert weight in fspen_module._WIDE
    weight.mul_(0.5)
    got = model.stream(folded, wav, chunk_frames=4)
    fresh = tree_map(lambda t: t.clone(), folded)
    assert torch.equal(got, model.stream(fresh, wav, chunk_frames=4))
    assert not torch.equal(got, first)


def _specs_and_wavs():
    rng = np.random.default_rng(5)
    specs = [(rng.standard_normal((2, 9, 7, 2)) * 0.3).astype(np.float32)
             for _ in range(2)]
    wavs = [(rng.standard_normal((2, 400)) * 0.1).astype(np.float32)
            for _ in range(2)]
    wavs[0] = (wavs[0] + 0.8 * wavs[1]).astype(np.float32)
    return specs, wavs


def _losses_print(pkg):
    cfg = {"wav_l1": {"weight": 1.0}, "mag_mse": {"weight": 0.5},
           "si_snr": {"weight": 0.1}}
    losses = pkg.Losses(cfg)
    for per_loss, rows in (({"wav_l1": 0.125, "mag_mse": 3.0e-3,
                             "si_snr": -12.5}, 4),
                           ({"wav_l1": 0.25, "mag_mse": 1.0e-3,
                             "si_snr": -10.0}, 2)):
        losses.accumulate(per_loss, rows)
    return losses.print()


def _printed(fn, capsys):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["si_snr_loss", "wav_l1_loss",
                                  "mag_mse_loss", "complex_mse_loss",
                                  "phase_loss", "Losses.print",
                                  "clear_previous_line", "progress"])
def test_public_names_match_jax(name, capsys):
    if name == "Losses.print":
        assert _losses_print(tlosses) == _losses_print(jlosses)
        return
    if name in ("clear_previous_line", "progress"):
        args = ("Epoch 3 - Train 5/10",) if name == "progress" else ()
        got = _printed(lambda: getattr(tterminal, name)(*args), capsys)
        want = _printed(lambda: getattr(jterminal, name)(*args), capsys)
        assert got == want and got
        return
    specs, wavs = _specs_and_wavs()
    pair = wavs if name in ("si_snr_loss", "wav_l1_loss") else specs
    got = float(getattr(tlosses, name)(*map(torch.from_numpy, pair)))
    want = float(getattr(jlosses, name)(*map(jnp.asarray, pair)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
