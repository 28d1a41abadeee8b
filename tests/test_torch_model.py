"""PyTorch port of models/fastenhancer/default.py against the JAX package.

The tiny FastEnhancer of tests/test_ops_pallas.py (2 blocks, C=8, F'=8,
n_fft 128) with JAX weights moved across by the bridge. Tolerances: 1e-5
on trees and masks (float32, unit-scale), 1e-4 on stream outputs (float32
over ~20 frames of recurrence).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.utils import from_jax, to_numpy

from _torch_parity import (TINY_KWARGS, as_np, assert_trees_close,
                           flatten_paths, one_thread_env, perturb_bn_stats,
                           port_variables, real_triton_only, to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = TINY_KWARGS["hop_size"]
N_FRAMES = 20
# the default model's other options, which no shipped config turns on
VARIANT = dict(rnnformer_kwargs=dict(
    TINY_KWARGS["rnnformer_kwargs"], pre_norm=True, post_act=True,
    attn_bias=True, positional_embedding=None, eps=1e-5),
    resnet=True, mask="sigmoid", activation="ReLU", pre_post_init=None)


def _models(**over):
    kw = dict(TINY_KWARGS, **over)
    return JModel(**kw), TModel(**kw)


def _variables(jm, seed):
    """Unfolded JAX variables with random BN stats, and the port's copy."""
    jv = perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)), seed)
    jv = jax.tree.map(jnp.asarray, jv)
    return jv, port_variables(jv)


def _wav(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * N_FRAMES)) * 0.3).astype(np.float32)


def test_init_tree_matches_jax():
    """Same paths and shapes as the JAX init, uniform inits within their
    torch-default bounds, identity BatchNorm, pe and filterbanks equal."""
    jm, tm = _models()
    j = flatten_paths(to_np_tree(jm.init(jax.random.PRNGKey(0))))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        assert tuple(t[path].shape) == j[path].shape, path
        assert t[path].dtype == torch.float32, path
    for path in [p for p in j if p[-1] in ("mean", "var")]:
        np.testing.assert_array_equal(t[path].numpy(), j[path])
    for path in (("params", "rf_blocks", "0", "pe", "weight"),
                 ("params", "rf_pre", "lin", "weight"),
                 ("params", "dec_post", "convt", "scale")):
        np.testing.assert_allclose(t[path].numpy(), j[path], atol=1e-7)
    w = t[("params", "rf_blocks", "1", "rnn", "weight_hh", "v")]
    assert w.abs().max() <= 1 / 8 ** 0.5  # U(+-1/sqrt(hidden))
    again = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["params"]["rf_blocks"][1]["rnn"]["weight_hh"]["v"],
                       w)


def test_bridge_round_trip():
    """from_jax then to_numpy gives back every leaf at its path, with the
    weight-norm {g, v} dicts, the folded tree's None entries and its empty
    stats dicts."""
    jm, _ = _models()
    jv = jm.init(jax.random.PRNGKey(1))
    for tree in (jv, jm.fold(jv)):
        np_tree = to_np_tree(tree)
        back = to_numpy(from_jax(np_tree, device="cpu"))
        a, b = flatten_paths(np_tree), flatten_paths(back)
        assert a.keys() == b.keys()
        for path in a:
            if a[path] is None:
                assert b[path] is None
            else:
                np.testing.assert_array_equal(b[path], a[path])
    folded = from_jax(to_np_tree(jm.fold(jv)), device="cpu")
    assert folded["params"]["rf_blocks"][0]["rnn_post_norm"] is None
    assert folded["stats"]["encoder"] == [{}]
    bf = from_jax({"w": np.ones(3, jnp.bfloat16)}, device="cpu")
    assert bf["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("over", [{}, VARIANT], ids=["tiny", "variant"])
def test_fold_matches_jax(over):
    jm, tm = _models(**over)
    jv, tv = _variables(jm, 2)
    assert_trees_close(tm.fold(tv), jm.fold(jv), atol=1e-5)


@pytest.mark.parametrize("over", [{}, VARIANT], ids=["tiny", "variant"])
def test_offline_forward_matches_jax(over):
    jm, tm = _models(**over)
    jv, tv = _variables(jm, 3)
    wav = _wav(2, 3)
    wj, sj, _ = jm.forward(jv, jnp.asarray(wav), train=False)
    wt, st, _ = tm.forward(tv, torch.tensor(wav))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    wt, st, new_stats = tm.forward(tv, torch.tensor(wav), train=True)
    assert torch.isfinite(wt).all() and torch.isfinite(st).all()
    new, old = flatten_paths(new_stats), flatten_paths(tv["stats"])
    assert new.keys() == old.keys()
    assert all(torch.isfinite(v).all() for v in new.values())
    assert any(not torch.equal(new[k], old[k]) for k in old)


@pytest.mark.usefixtures("real_triton_only")
def test_remat_matches_plain_forward():
    """train.remat (gradient checkpointing): the train forward with remat
    equals the one without bit for bit (outputs and new statistics; its
    gradients: tests/test_torch_train.py), and eval mode ignores it, as in
    the JAX package. torch.utils.checkpoint imports torch._dynamo, hence
    the real_triton_only fixture."""
    jm, tm = _models()
    _, tv = _variables(jm, 3)
    wav = torch.tensor(_wav(2, 3))
    plain = tm.forward(tv, wav, train=True)
    tm.remat = True
    remat = tm.forward(tv, wav, train=True)
    for a, b in zip(plain[:2], remat[:2]):
        assert torch.equal(a, b)
    new, want = flatten_paths(remat[2]), flatten_paths(plain[2])
    assert new.keys() == want.keys()
    assert all(torch.equal(new[k], want[k]) for k in want)
    assert torch.isfinite(tm.forward(tv, wav)[0]).all()


@pytest.mark.parametrize("over,folded", [({}, False), ({}, True),
                                         (VARIANT, True)],
                         ids=["tiny", "tiny-folded", "variant-folded"])
def test_streaming_step_matches_jax(over, folded):
    """Per-hop streaming_step over 20 frames, carries fed back on both
    sides: every output hop and the final GRU carries agree."""
    jm, tm = _models(stft_method="matmul", **over)
    jv, tv = _variables(jm, 4)
    if folded:
        jv, tv = jm.fold(jv), tm.fold(tv)
    wav = _wav(3, 4)
    cj = jm.init_streaming_carry(3)
    ct = tm.init_streaming_carry(3, torch.float32, "cpu")
    step_j = jax.jit(jm.streaming_step)
    for i in range(N_FRAMES):
        hop = wav[:, i * HOP:(i + 1) * HOP]
        cj, yj = step_j(jv, cj, jnp.asarray(hop))
        ct, yt = tm.streaming_step(tv, ct, torch.tensor(hop))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
    for hj, ht in zip(cj["h"], ct["h"]):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4)


def test_fused_step_and_stream_match_jax():
    """streaming_step_fused (the kernel's plain version on the CPU) against
    JAX's Pallas-fused stream, and stream() with and without the plan."""
    jm, tm = _models()
    jv, tv = _variables(jm, 5)
    jf, tf = jm.fold(jv), tm.fold(tv)
    wav = _wav(2, 5)
    y_j = np.asarray(jm.stream(jf, jnp.asarray(wav),
                               fused_plan=jm.build_stack_plan(jf)))
    plan = tm.build_stack_plan(tf)
    y_fused = tm.stream(tf, torch.tensor(wav), fused_plan=plan).numpy()
    y_plain = tm.stream(tf, torch.tensor(wav)).numpy()
    np.testing.assert_allclose(y_fused, y_j, atol=1e-4)
    np.testing.assert_allclose(y_plain, y_fused, atol=1e-5)
    # model_forward_fused against model_forward, frame by frame
    params, stats = tf["params"], tf["stats"]
    rng = np.random.default_rng(5)
    h_list = [torch.zeros(2 * tm.block_freq, tm.block_channels)
              for _ in range(tm.num_blocks)]
    h = torch.stack(h_list)
    for _ in range(3):
        spec = torch.tensor(rng.standard_normal(
            (2, tm.stft_cfg.n_freq - 1, 1, 2)).astype(np.float32) * 0.3)
        m_ref, h_list, _ = tm.model_forward(params, stats, spec, h0=h_list)
        m_fused, h = tm.model_forward_fused(tf, plan, spec, h)
        np.testing.assert_allclose(m_fused.numpy(), m_ref.numpy(), atol=1e-5)
        np.testing.assert_allclose(h.numpy(), torch.stack(h_list).numpy(),
                                   atol=1e-5)
    # a plan takes one frame a step; chunked streaming runs unfused
    with pytest.raises(ValueError, match="fused_plan"):
        tm.stream(tf, torch.tensor(wav), chunk_frames=2, fused_plan=plan)
    np.testing.assert_allclose(
        tm.stream(tf, torch.tensor(wav), chunk_frames=2).numpy(), y_plain,
        atol=1e-4)


def test_streaming_equals_offline():
    """Port streaming == port offline model_forward (time-batched GRU) on the
    same center=False framing with the cache_len zeros prepended."""
    from fastenhancer_tpu_torch.functional import (STFTConfig, compress,
                                                   overlap_add, stft,
                                                   uncompress)

    jm, tm = _models()
    _, tv = _variables(jm, 6)
    wav = torch.tensor(_wav(2, 6))
    y_stream = tm.stream(tv, wav)

    cfg = tm.stft_cfg
    ocfg = STFTConfig(n_fft=cfg.n_fft, hop_size=cfg.hop_size, center=False)
    padded = torch.nn.functional.pad(wav, (cfg.cache_len, 0))
    spec = compress(stft(padded, ocfg)[:, :-1], tm.input_compression)
    mask, _, _ = tm.model_forward(tv["params"], tv["stats"], spec)
    spec_hat = uncompress(tm.complex_mask_mul(spec, mask),
                          tm.input_compression)
    spec_hat = torch.cat([spec_hat, torch.zeros_like(spec_hat[:, :1])], 1)
    frames = torch.fft.irfft(torch.complex(spec_hat[..., 0], spec_hat[..., 1])
                             .transpose(1, 2), n=cfg.n_fft, dim=-1)
    frames = frames * cfg.tensor("synthesis_window", frames.device)
    y_offline = overlap_add(frames, cfg.hop_size)[:, :wav.shape[1]]
    np.testing.assert_allclose(y_stream.numpy(), y_offline.numpy(), atol=1e-4)


def test_get_model_registry():
    from fastenhancer_tpu_torch.models.fastenhancer import (conv_stft, ln,
                                                            noncausal,
                                                            time_kernel)

    _, tm = _models()
    m = get_model("fastenhancer.default", **TINY_KWARGS)
    assert isinstance(m, TModel) and m.block_freq == tm.block_freq
    assert isinstance(get_model("fastenhancer.ln", **TINY_KWARGS), ln.Model)
    assert isinstance(get_model("fastenhancer.conv_stft", **TINY_KWARGS),
                      conv_stft.Model)
    assert isinstance(get_model("fastenhancer.time_kernel", channels=12),
                      time_kernel.Model)
    assert isinstance(get_model("fastenhancer.noncausal", **TINY_KWARGS),
                      noncausal.Model)
    from fastenhancer_tpu_torch.models import fspen, lisennet
    from fastenhancer_tpu_torch.presets import FSPEN, LISENNET

    assert isinstance(get_model("fspen", **FSPEN), fspen.Model)
    assert isinstance(get_model("lisennet", **LISENNET), lisennet.Model)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("fastenhancer.nonexistent")


def test_conv_stft_forward_matches_jax():
    """conv_stft is the default model with the matmul-DFT front end: the
    same tree, and its offline forward and stream agree with JAX's."""
    from fastenhancer_tpu.models.fastenhancer.conv_stft import Model as JConv

    jm = JConv(**TINY_KWARGS)
    tm = get_model("fastenhancer.conv_stft", **TINY_KWARGS)
    assert tm.stft_cfg.method == jm.stft_cfg.method == "matmul"
    jv, tv = _variables(jm, 7)
    wav = _wav(2, 7)
    wj, sj, _ = jm.forward(jv, jnp.asarray(wav), train=False)
    wt, st, _ = tm.forward(tv, torch.tensor(wav))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    jf, tf = jm.fold(jv), tm.fold(tv)
    y_j = np.asarray(jm.stream(jf, jnp.asarray(wav[:, :HOP * 8])))
    y_t = tm.stream(tf, torch.tensor(wav[:, :HOP * 8])).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-4)


_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "fastenhancer_tpu", "yaml", "tensorboardX",
           "matplotlib", "google.protobuf", "PIL")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
import fastenhancer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from fastenhancer_tpu_torch.models import get_model
kw = dict(channels=12, kernel_size=[4, 3], stride=4,
          rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2),
          n_fft=128, hop_size=64, win_size=128, weight_norm=True,
          pre_post_init="linear_fixed")
model = get_model("fastenhancer.default", **kw)
folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
wav = torch.randn(2, 64 * 6, generator=torch.Generator().manual_seed(1))
y = model.stream(folded, wav, fused_plan=model.build_stack_plan(folded))
assert y.shape == wav.shape and torch.isfinite(y).all()
# the whole-frame step, and the dpt model's fused stream
model = get_model("fastenhancer.default", **dict(kw, kernel_size=[8, 3],
                                                 activation="SiLU"))
folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
carry = model.init_streaming_carry(2, torch.float32, "cpu", fused=True)
carry, y = model.streaming_step_fused_frame(
    folded, model.build_frame_plan(folded), carry, wav[:, :64])
assert y.shape == (2, 64) and torch.isfinite(y).all()
dkw = {k: v for k, v in kw.items() if k != "rnnformer_kwargs"}
model = get_model("fastenhancer.dptransformer", **dkw, dpt_kwargs=dict(
    num_blocks=1, channels=8, freq=8, num_heads=2, lookbehind=3))
folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
y = model.stream(folded, wav, fused_plan=model.build_stack_plan(folded))
assert y.shape == wav.shape and torch.isfinite(y).all()
# the bsrnn and dprnn models' fused streams
model = get_model("bsrnn", num_channels=4, num_layers=1)
folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
wav = torch.randn(2, 256 * 3, generator=torch.Generator().manual_seed(1))
y = model.stream(folded, wav, fused_plan=model.build_stack_plan(folded))
assert y.shape == wav.shape and torch.isfinite(y).all()
model = get_model("fastenhancer.dprnn", **dkw, dprnn_kwargs=dict(
    num_blocks=1, channels=8, channels_frnn=4, freq=8))
folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
y = model.stream(folded, wav, fused_plan=model.build_stack_plan(folded))
assert y.shape == wav.shape and torch.isfinite(y).all()
# the ln and time_kernel models' fused streams
for name, mkw in (("fastenhancer.ln", kw),
                  ("fastenhancer.time_kernel",
                   dict({k: v for k, v in kw.items() if k != "kernel_size"},
                        kernel_size_freq=[4, 3]))):
    model = get_model(name, **mkw)
    folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
    y = model.stream(folded, wav, fused_plan=model.build_stack_plan(folded))
    assert y.shape == wav.shape and torch.isfinite(y).all()
# chunked streaming, and the noncausal model's offline forward
model = get_model("fastenhancer.default", **kw)
folded = model.fold(model.init(torch.Generator().manual_seed(0), "cpu"))
y = model.stream(folded, wav, chunk_frames=4)
assert y.shape == wav.shape and torch.isfinite(y).all()
model = get_model("fastenhancer.noncausal", **kw)
y, _, _ = model.forward(model.init(torch.Generator().manual_seed(0), "cpu"),
                        wav)
assert y.shape == wav.shape and torch.isfinite(y).all()
from fastenhancer_tpu_torch.presets import (BSRNN_S, DPRNN_B, DPT_B, FE_B,
                                            LN_B, NONCAUSAL_HUGE,
                                            TIME_KERNEL_B)
assert get_model("fastenhancer.noncausal", **NONCAUSAL_HUGE).num_blocks == 6
assert get_model("fastenhancer.ln", **LN_B).block_freq == 24
assert get_model("fastenhancer.time_kernel", **TIME_KERNEL_B).kernel_size_time == 3
assert get_model("fastenhancer.dptransformer", **DPT_B).dpt.lookbehind == 31
assert get_model("fastenhancer.default", **FE_B).block_freq == 24
assert get_model("fastenhancer.dprnn", **DPRNN_B).dp.channels_frnn == 18
assert get_model("bsrnn", **BSRNN_S).channels == 64
# the shard recipe's wrapper at the tiny width: one mixed train step
import copy, numpy as np
from fastenhancer_tpu_torch.data import ShardBatch
from fastenhancer_tpu_torch.presets import FE_T_SHARD
from fastenhancer_tpu_torch.utils.hparams import HParams
from fastenhancer_tpu_torch.wrappers import get_wrapper
hps = copy.deepcopy(FE_T_SHARD)
hps["model_kwargs"] = dict(kw)
hps["train"]["steps_per_epoch"] = 1
w = get_wrapper("ns_shard")(HParams(**hps), train=True, device="cpu")
x = np.random.default_rng(0).standard_normal((2, 1, 64 * 8)).astype("f4")
rir = np.zeros((2, 1, 100), "f4")
rir[:, 0, 0] = 1.0
batch = ShardBatch(speech=x, speech_clean=x, noise=x[::-1].copy(), rir=rir,
                   rir_onset=np.zeros(2, "i8"), rir_t60=np.full(2, 1e-3),
                   num_samples=np.full(2, 512), id_speech=["a", "b"])
assert all(np.isfinite(v) for v in w.train_epoch([batch])["scalars"].values())
# the recipe's config through the port's own YAML reader
from fastenhancer_tpu_torch.utils.hparams import get_hparams
hps = get_hparams("configs/fastenhancer_shard/t.yaml").to_dict()
assert hps["train"] == FE_T_SHARD["train"]
# the on-the-fly recipe's wrapper (the 48 kHz config: its low-pass, and
# reverb on): one mixed train step
hps = get_hparams("configs/fastenhancer_48khz/t.yaml").to_dict()
hps["model_kwargs"] = dict(kw)
hps["data"].update(reverb_prob=0.5, rir_length=64)
hps.pop("pesq")
w = get_wrapper("ns_on_the_fly")(HParams(**hps), train=True, device="cpu")
rng = np.random.default_rng(1)
raw = {"clean": (rng.standard_normal((2, 64 * 8)) * 0.1).astype("f4"),
       "noise": (rng.standard_normal((2, 64 * 8)) * 0.1).astype("f4"),
       "rir": np.eye(2, 64, dtype="f4")}
assert all(np.isfinite(v) for v in w.train_epoch([raw])["scalars"].values())
# the summaries, the profiler and the native decoder
import os, tempfile
from fastenhancer_tpu_torch import native
from fastenhancer_tpu_torch.utils.event_file import EventWriter, read_events
from fastenhancer_tpu_torch.utils.profiler import StepProfiler
from fastenhancer_tpu_torch.utils.summarize import summarize
d = tempfile.mkdtemp()
ew = EventWriter(d)
summarize(ew, 1, 16000, scalars={"s": 1.0}, hists={"h": np.arange(5.0)},
          audios={"a": np.zeros(64)}, specs={"p": np.ones((4, 3))})
ew.close()
assert len([v for e in read_events(ew.path) for v in e["values"]]) == 4
prof = StepProfiler(d, start=0, steps=2)
for _ in range(3):
    torch.ones(3).sum()
    prof.step()
assert prof.done and os.path.exists(prof.trace_path)
assert native.available()
# the corpus tools: every script of the JAX package's scripts/data/ has its
# counterpart, and one shard_speech build is read back
from fastenhancer_tpu_torch.data.audio_io import write_wav
from fastenhancer_tpu_torch.data.shard import ShardSource
from fastenhancer_tpu_torch.scripts.data import shard_speech
tools = {f"fastenhancer_tpu_torch.scripts.data.{f[:-3]}"
         for f in os.listdir(os.path.join("scripts", "data"))
         if f.endswith(".py") and f != "__init__.py"}
assert len(tools) == 19 and tools <= set(names)
speech = os.path.join(d, "speech")
os.makedirs(speech)
for i in range(2):
    write_wav(os.path.join(speech, f"{i}.wav"), 0.3 * np.sin(
        0.05 * np.arange(16000 * (i + 1))).astype("f4"), 16000)
shard_speech.main(["-n", "sp", "-d", speech, "-s", os.path.join(d, "shards"),
                   "-j", "1"])
cuts = list(ShardSource(os.path.join(d, "shards", "sp")).iter_cuts(seed=0))
assert sorted(len(c.audio) for c in cuts) == [16000, 32000]
# the training demo's configs of both recipes, read and rewritten
from fastenhancer_tpu_torch.scripts import train_demo
dirs = {f"{s}_{k}": os.path.join(d, s, k) for s in ("train", "test")
        for k in ("clean", "noisy")}
for recipe in ("paired", "shard"):
    cfg = train_demo.demo_config(recipe, 4, 0, dirs, {"speech": speech})
    assert cfg["data"]["valid"]["clean_dir"] == dirs["test_clean"]
assert not any(blocked(m) for m in sys.modules)
assert {"fastenhancer_tpu_torch.scripts.enhance",
        "fastenhancer_tpu_torch.scripts.train_demo",
        "fastenhancer_tpu_torch.scripts.serve",
        "fastenhancer_tpu_torch.scripts.metrics_ns",
        "fastenhancer_tpu_torch.data.ns_on_the_fly",
        "fastenhancer_tpu_torch.wrappers.ns_on_the_fly",
        "fastenhancer_tpu_torch.utils.event_file",
        "fastenhancer_tpu_torch.utils.summarize",
        "fastenhancer_tpu_torch.utils.profiler",
        "fastenhancer_tpu_torch.utils.terminal",
        "fastenhancer_tpu_torch.native",
        "fastenhancer_tpu_torch.scripts.audiolib"} <= set(names)
print("OK", len(names))
"""


def test_port_imports_no_jax():
    """Every port module imports, and the tiny model's init -> fold ->
    fused stream, its whole-frame step, the dpt, bsrnn, dprnn, ln and
    time_kernel models' fused streams, a chunked stream, the noncausal
    model's forward, the presets, a train step of the shard recipe's
    wrapper and the recipe's config read, and a train step of the
    on-the-fly wrapper run, and the summaries are written and read back,
    a profiler window traced and the native decoder built, with jax,
    fastenhancer_tpu, yaml, tensorboardX, matplotlib, google.protobuf and
    PIL blocked (the card has none of them), and one shard_speech build is
    read back. Every port module imports, the scripts
    (`fastenhancer_tpu_torch.scripts.*`), the corpus tools (a counterpart
    of each of scripts/data/*.py), the summaries, the profiler and the
    native decoder among them."""
    env = one_thread_env(PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1].startswith("OK")
