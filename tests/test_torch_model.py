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
                           flatten_paths, perturb_bn_stats, port_variables,
                           to_np_tree)

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.forward(tv, torch.tensor(wav), train=True)


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.stream(tf, torch.tensor(wav), chunk_frames=2)


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
    _, tm = _models()
    m = get_model("fastenhancer.default", **TINY_KWARGS)
    assert isinstance(m, TModel) and m.block_freq == tm.block_freq
    for name in ("bsrnn", "fastenhancer.dprnn", "no.such.model"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            get_model(name)


_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "fastenhancer_tpu"):
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
assert not any(m.split(".")[0] in ("jax", "fastenhancer_tpu") for m in sys.modules)
print("OK", len(names))
"""


def test_port_imports_no_jax():
    """Every port module imports, and the tiny model's init -> fold ->
    fused stream runs, with jax and fastenhancer_tpu blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
