"""PyTorch port of models/fastenhancer/dptransformer.py against the JAX
package: the init tree and its fixed weights, fold, offline forward and
per-frame streaming, on a tiny dpt model with JAX weights moved across by
the bridge.

Tolerances: 1e-5 on trees and spectra (float32, unit scale); 1e-4 on
waveforms (float32 after the iSTFT, over more frames than the lookbehind).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.dptransformer import Model as JModel
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer.default import (
    rf_pre_post_weights)
from fastenhancer_tpu_torch.models.fastenhancer.dptransformer import (
    Model as TModel, hz_grid_linear_weights)

from _torch_parity import (assert_trees_close, check_train_forward_runs,
                           flatten_paths, perturb_bn_stats, port_variables,
                           to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HOP = 64
N_FRAMES = 9  # beyond the lookbehind of 5
# tests/test_ops_pallas.py::_tiny_dpt
DPT_KWARGS = dict(
    channels=12, kernel_size=[4, 3], stride=4,
    dpt_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                    lookbehind=5, positional_embedding="train"),
    n_fft=128, hop_size=HOP, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed", stft_method="matmul",
)
PRE_NORM = dict(dpt_kwargs=dict(DPT_KWARGS["dpt_kwargs"], pre_norm=True,
                                attn_bias=True, eps=1e-5))


def _models(**over):
    kw = dict(DPT_KWARGS, **over)
    return JModel(**kw), TModel(**kw)


def _variables(jm, seed):
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)),
                                       seed))
    return jv, port_variables(jv)


def _wav(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * N_FRAMES)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("over", [
    {}, dict(pre_post_init="mel_fixed"), dict(pre_post_init=None),
    dict(final_scale="exp", final_scale_init="1/sqrt(fan_in)"),
    dict(final_scale=False), PRE_NORM],
    ids=["linear", "mel", "learned", "exp-scale", "no-scale", "pre_norm"])
def test_init_tree_and_fixed_weights_match_jax(over):
    """Same paths, shapes and dtypes as the JAX init, and the same fixed
    weights: rf_pre/rf_post filterbanks, time_pe, pe, the final scale."""
    jm, tm = _models(**over)
    j = flatten_paths(to_np_tree(jm.init(jax.random.PRNGKey(0))))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        assert tuple(t[path].shape) == j[path].shape, path
        assert t[path].dtype == torch.float32, path
    fixed = [("params", "time_pe", "weight"),
             ("params", "rf_blocks", "0", "pe", "weight")]
    if tm.pre_post_init is not None:
        fixed += [("params", n, "lin", "weight") for n in ("rf_pre", "rf_post")]
    if tm.final_scale is not False:
        fixed.append(("params", "dec_post", "convt", "scale"))
    for path in fixed:
        np.testing.assert_allclose(t[path].numpy(), j[path], atol=1e-6,
                                   err_msg=str(path))


def test_dpt_filterbank_is_not_the_default_models():
    """The dpt init overrides rf_pre/rf_post with the absolute-Hz grid; the
    default model's filterbank differs, so reusing it would be wrong."""
    hz_pre, hz_post = hz_grid_linear_weights(64, 24)
    pre, post = rf_pre_post_weights(64, 24, "linear_fixed")
    assert hz_pre.shape == pre.shape and hz_post.shape == post.shape
    assert np.abs(hz_pre - pre).max() > 1e-2


@pytest.mark.parametrize("over", [{}, PRE_NORM], ids=["plain", "pre_norm"])
def test_fold_matches_jax(over):
    jm, tm = _models(**over)
    jv, tv = _variables(jm, 1)
    assert_trees_close(tm.fold(tv), jm.fold(jv), atol=1e-5)


@pytest.mark.parametrize("over", [{}, PRE_NORM], ids=["plain", "pre_norm"])
def test_offline_forward_matches_jax(over):
    """Banded causal time attention over all frames at once."""
    jm, tm = _models(**over)
    jv, tv = _variables(jm, 2)
    wav = _wav(2, 2)
    wj, sj, _ = jm.forward(jv, jnp.asarray(wav), train=False)
    wt, st, _ = tm.forward(tv, torch.tensor(wav))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)


@pytest.mark.parametrize("over,folded", [({}, False), ({}, True),
                                         (PRE_NORM, True)],
                         ids=["unfolded", "folded", "pre_norm-folded"])
def test_streaming_step_matches_jax(over, folded):
    """Per-frame streaming_step, the per-block K/V carries fed back on both
    sides: every output hop and the final carries agree."""
    jm, tm = _models(**over)
    jv, tv = _variables(jm, 3)
    if folded:
        jv, tv = jm.fold(jv), tm.fold(tv)
    wav = _wav(3, 3)
    cj = jm.init_streaming_carry(3)
    ct = tm.init_streaming_carry(3, torch.float32, "cpu")
    step_j = jax.jit(jm.streaming_step)
    for i in range(N_FRAMES):
        hop = wav[:, i * HOP:(i + 1) * HOP]
        cj, yj = step_j(jv, cj, jnp.asarray(hop))
        ct, yt = tm.streaming_step(tv, ct, torch.tensor(hop))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
    assert_trees_close(ct["h"], cj["h"], atol=1e-4)


def test_registry_and_unported_modes():
    m = get_model("fastenhancer.dptransformer", **DPT_KWARGS)
    assert isinstance(m, TModel) and m.dpt.lookbehind == 5
    _, tv = _variables(_models()[0], 4)
    wav = torch.tensor(_wav(1, 4))
    check_train_forward_runs(m, tv, wav)
    # chunked streaming runs (unfused), the tail cut to a multiple of 2
    assert m.stream(tv, wav, chunk_frames=2).shape == (1, HOP * 8)
    with pytest.raises(ValueError, match="final_scale"):
        TModel(**dict(DPT_KWARGS, final_scale="log"))
