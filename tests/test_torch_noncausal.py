"""PyTorch port of models/fastenhancer/noncausal.py against the JAX package.

The tiny FastEnhancer of tests/test_ops_pallas.py with a bidirectional time
GRU, JAX weights moved across by the bridge. Tolerances: float32 1e-5 on
trees, spectra and wavs; bfloat16 2^-5 of the peak (a few bf16 ulps),
stated and checked with a control at the test.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu import nn as jnn
from fastenhancer_tpu.models.fastenhancer.noncausal import Model as JModel
from fastenhancer_tpu_torch import nn as tnn
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer import noncausal
from fastenhancer_tpu_torch.models.fastenhancer.dptransformer import (
    hz_grid_linear_weights)
from fastenhancer_tpu_torch.models.fastenhancer.noncausal import (
    Model as TModel)
from fastenhancer_tpu_torch.ops import gru_scan as tscan
from fastenhancer_tpu_torch.presets import NONCAUSAL_HUGE
from fastenhancer_tpu_torch.utils import cast_floating

from _torch_parity import (TINY_KWARGS, assert_trees_close,
                           check_train_forward_runs, flatten_paths,
                           perturb_bn_stats, port_variables, to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5
BF16_REL = 2 ** -5
HOP = TINY_KWARGS["hop_size"]
# the default model's other options, which no shipped config turns on
VARIANT = dict(rnnformer_kwargs=dict(
    TINY_KWARGS["rnnformer_kwargs"], pre_norm=True, post_act=True,
    attn_bias=True, positional_embedding=None, eps=1e-5),
    mask="sigmoid", activation="ReLU", pre_post_init=None)


def _models(**over):
    kw = dict(TINY_KWARGS, **over)
    return JModel(**kw), TModel(**kw)


def _variables(jm, seed):
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)),
                                       seed))
    return jv, port_variables(jv)


def _wav(b, frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * frames)) * 0.3).astype(np.float32)


def test_init_tree_matches_jax():
    """Same paths and shapes as the JAX init (a {fwd, bwd} GRU a block,
    rnn_fc 2C -> C), the absolute-Hz linear filterbanks equal, the GRU
    within torch's default bound; the huge recipe's tree too (shapes only,
    through jax.eval_shape)."""
    jm, tm = _models()
    j = flatten_paths(to_np_tree(jm.init(jax.random.PRNGKey(0))))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        assert tuple(t[path].shape) == j[path].shape, path
    pre, post = hz_grid_linear_weights(tm.freq, tm.block_freq)
    np.testing.assert_array_equal(
        t[("params", "rf_pre", "lin", "weight")].numpy(), pre)
    np.testing.assert_array_equal(
        t[("params", "rf_post", "lin", "weight")].numpy(), post)
    np.testing.assert_array_equal(j[("params", "rf_pre", "lin", "weight")],
                                  pre)
    assert t[("params", "rf_blocks", "0", "rnn_fc", "weight")].shape == (8, 16)
    w = t[("params", "rf_blocks", "1", "rnn", "bwd", "weight_hh", "v")]
    assert w.abs().max() <= 1 / 8 ** 0.5
    jh = JModel(**NONCAUSAL_HUGE)
    th = get_model("fastenhancer.noncausal", **NONCAUSAL_HUGE)
    shapes = flatten_paths(jax.eval_shape(jh.init, jax.random.PRNGKey(0)))
    t = flatten_paths(th.init(torch.Generator().manual_seed(0), "cpu"))
    assert shapes.keys() == t.keys()
    for path, s in shapes.items():
        assert tuple(t[path].shape) == s.shape, path


@pytest.mark.parametrize("over", [{}, VARIANT], ids=["tiny", "variant"])
def test_forward_and_fold_match_jax(over):
    """The offline forward, unfolded and folded, and fold() itself, in
    float32 within 1e-5 of JAX's; the variant turns on pre-norms (folded
    into both GRU directions and the qkv), post_act, the attention bias,
    the sigmoid mask and a learned filterbank."""
    jm, tm = _models(**over)
    jv, tv = _variables(jm, 1)
    jf, tf = jm.fold(jv), tm.fold(tv)
    assert_trees_close(tf, jf, atol=ATOL)
    wav = _wav(3, 16, 1)
    for j_vars, t_vars in ((jv, tv), (jf, tf)):
        wj, sj, _ = jm.forward(j_vars, jnp.asarray(wav), train=False)
        wt, st, _ = tm.forward(t_vars, torch.tensor(wav))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ATOL)


def test_eval_runs_each_direction_as_one_scan(monkeypatch):
    """In eval, each block's time GRU is two gru_scan launches over all T
    frames (forward, then backward on the time-flipped input) from zero
    states, and bigru_fused gives nn.bigru's [forward, backward] layout
    (float32, 1e-6)."""
    jm, tm = _models()
    _, tv = _variables(jm, 2)
    calls = []
    real = tscan.gru_scan

    def spy(x_proj, h0, w_hh, b_hh):
        calls.append((tuple(x_proj.shape), bool(h0.abs().max() == 0)))
        return real(x_proj, h0, w_hh, b_hh)

    monkeypatch.setattr(tscan, "gru_scan", spy)
    wav = torch.tensor(_wav(2, 16, 2))
    tm.forward(tv, wav)
    t = tm.stft(wav).shape[2]
    assert calls == [((t, 2 * tm.block_freq, 3 * tm.block_channels), True)
                     ] * (2 * tm.num_blocks)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((7, 5, 8)).astype(np.float32))
    params = tv["params"]["rf_blocks"][0]["rnn"]
    np.testing.assert_allclose(tscan.bigru_fused(params, x).numpy(),
                               tnn.bigru(params, x).numpy(), atol=1e-6)


def test_bf16_forward_and_bigru_match_jax():
    """bfloat16 against JAX's bf16, tolerance 2^-5 of the peak. The whole
    forward's compressed spectrum (measured at most 9.4e-3 of the peak on
    seeds 1-7), and one block's bidirectional GRU alone, port bigru_fused
    against JAX's nn.bigru over 16 frames (the port keeps the state in
    float32 and rounds each output once; JAX rounds the state every step).
    Control: the backward direction run on the unflipped input misses the
    GRU's bound."""
    jm, tm = _models()
    jv, tv = _variables(jm, 2)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jv)
    tb = cast_floating(tv, torch.bfloat16)
    wav = _wav(3, 16, 2)
    _, sj, _ = jm.forward(jb, jnp.asarray(wav, jnp.bfloat16), train=False)
    _, st, _ = tm.forward(tb, torch.tensor(wav).bfloat16())
    assert st.dtype == torch.bfloat16
    sj = np.asarray(sj.astype(jnp.float32))
    np.testing.assert_allclose(st.float().numpy(), sj,
                               atol=BF16_REL * np.abs(sj).max())

    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 24, 8)).astype(np.float32)
    params = jb["params"]["rf_blocks"][0]["rnn"]
    plain = {d: {k: jnn.maybe_wn_weight(params[d], k)
                 if k.startswith("weight") else params[d][k]
                 for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
             for d in ("fwd", "bwd")}
    y_j = np.asarray(jnn.bigru(plain, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    t_params = tb["params"]["rf_blocks"][0]["rnn"]
    xt = torch.tensor(x).bfloat16()
    y_t = tscan.bigru_fused(t_params, xt)
    tol = BF16_REL * np.abs(y_j).max()
    assert np.abs(y_t.float().numpy() - y_j).max() <= tol
    unflipped = torch.cat([tscan.gru_fused(t_params["fwd"], xt)[0],
                           tscan.gru_fused(t_params["bwd"], xt)[0]], dim=-1)
    assert np.abs(unflipped.float().numpy() - y_j).max() > tol


def test_streaming_and_training_raise():
    """No streaming graph (as in JAX and the reference), and training runs
    (its parity with JAX: tests/test_torch_train_fe_variants.py); a mel
    filterbank init is refused."""
    jm, tm = _models()
    _, tv = _variables(jm, 3)
    wav = torch.tensor(_wav(1, 8, 3))
    with pytest.raises(NotImplementedError):
        jm.init_streaming_carry(1)
    for call in (lambda: tm.init_streaming_carry(1, torch.float32, "cpu"),
                 lambda: tm.streaming_step(tv, {}, wav[:, :HOP]),
                 lambda: tm.streaming_chunk(tv, {}, wav),
                 lambda: tm.stream(tv, wav),
                 lambda: tm.stream(tv, wav, chunk_frames=4)):
        with pytest.raises(NotImplementedError, match="streaming graph"):
            call()
    check_train_forward_runs(tm, tv, wav)
    with pytest.raises(ValueError, match="linear"):
        TModel(**dict(TINY_KWARGS, pre_post_init="mel_fixed"))


def test_torch_names_and_registry():
    """Every param path gets JAX's reference torch name (the biGRU's
    *_l0 and *_l0_reverse, weight norm's parametrizations); the registry
    builds the huge recipe."""
    jm, tm = _models()
    params = tm.init(torch.Generator().manual_seed(0), "cpu")["params"]
    for path in flatten_paths(params):
        assert tm.torch_name(path) == jm.torch_name(path), path
    assert tm.torch_name(("rf_blocks", "1", "rnn", "bwd", "weight_hh",
                          "g")) == ("rf_block.1.rnn.parametrizations."
                                    "weight_hh_l0_reverse.original0")
    m = get_model("fastenhancer.noncausal", **NONCAUSAL_HUGE)
    assert isinstance(m, noncausal.Model)
    assert (m.num_blocks, m.block_freq, m.block_channels, m.hop_size) == (
        6, 64, 128, 100)
