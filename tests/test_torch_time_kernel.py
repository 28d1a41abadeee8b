"""PyTorch port of models/fastenhancer/time_kernel.py (the time_kernel
ablation) against the JAX package.

The tiny time_kernel model of tests/test_ops_pallas.py (2-D causal encoder
and decoder2 convs with k_t = 3, 2 blocks, C'=8, F'=8, n_fft 128), with
random BatchNorm statistics so that fold merges them into the 4-D weights,
moved across by the bridge. The JAX fused stream runs the Pallas stack
kernel in interpret mode. Tolerances (float32): 1e-5 on trees, specs,
masks and stream outputs.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.time_kernel import Model as JModel
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer.time_kernel import (
    Model as TModel)
from fastenhancer_tpu_torch.serving import StreamingEngine

from _torch_parity import (assert_trees_close,
                           check_engine_fused_matches_unfused,
                           check_train_forward_runs, flatten_paths,
                           perturb_bn_stats, port_variables, to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KWARGS = dict(
    channels=12, kernel_size_freq=[4, 3], kernel_size_time=3, stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                          positional_embedding="train"),
    n_fft=128, hop_size=64, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed",
)
HOP = KWARGS["hop_size"]
N_FRAMES = 14
ATOL = 1e-5


def _models():
    return JModel(**KWARGS), TModel(**KWARGS)


def _variables(jm, seed):
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)),
                                       seed))
    return jv, port_variables(jv)


def _wav(b, seed, frames=N_FRAMES):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * frames)) * 0.3).astype(np.float32)


def test_init_tree_matches_jax():
    """Same paths and shapes as the JAX init: [Cout, Cin, k_t, k_f]
    encoder and decoder2 weights, the rest the default model's."""
    jm, tm = _models()
    j = flatten_paths(to_np_tree(jm.init(jax.random.PRNGKey(0))))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        assert tuple(t[path].shape) == j[path].shape, path
    assert t[("params", "encoder", "0", "conv", "weight")].shape == (
        12, 12, 3, 3)
    w = t[("params", "decoder", "0", "conv2", "weight")]
    assert w.abs().max() <= 1 / (12 * 3 * 3) ** 0.5
    np.testing.assert_allclose(t[("params", "rf_pre", "lin", "weight")],
                               j[("params", "rf_pre", "lin", "weight")],
                               atol=1e-7)


def test_fold_and_forward_match_jax():
    """fold merges BN into the 4-D conv weights as JAX does, and the
    offline forward agrees on unfolded and folded variables."""
    jm, tm = _models()
    jv, tv = _variables(jm, 1)
    jf, tf = jm.fold(jv), tm.fold(tv)
    assert tf["params"]["encoder"][0]["conv"]["weight"].ndim == 4
    assert_trees_close(tf, jf, atol=ATOL)
    wav = _wav(2, 1)
    for j_vars, t_vars in ((jv, tv), (jf, tf)):
        wj, sj, _ = jm.forward(j_vars, jnp.asarray(wav), train=False)
        wt, st, _ = tm.forward(t_vars, torch.tensor(wav))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ATOL)
    check_train_forward_runs(tm, tv, torch.tensor(wav))


def test_stream_unfused_and_fused_match_jax():
    """stream() on folded variables, over 14 frames so the conv caches and
    the GRU carries both go round: unfused against JAX's XLA stream, fused
    (the stack's plain version) against JAX's Pallas-fused stream, and the
    final carries of streaming_step against JAX's."""
    jm, tm = _models()
    jv, tv = _variables(jm, 2)
    jf, tf = jm.fold(jv), tm.fold(tv)
    wav = _wav(3, 2)
    y_j = np.asarray(jm.stream(jf, jnp.asarray(wav)))
    y_j_fused = np.asarray(jm.stream(jf, jnp.asarray(wav),
                                     fused_plan=jm.build_stack_plan(jf)))
    plan = tm.build_stack_plan(tf)
    y_t = tm.stream(tf, torch.tensor(wav)).numpy()
    y_t_fused = tm.stream(tf, torch.tensor(wav), fused_plan=plan).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)
    np.testing.assert_allclose(y_t_fused, y_j_fused, atol=ATOL)
    np.testing.assert_allclose(y_t_fused, y_t, atol=ATOL)
    cj = jm.init_streaming_carry(3)
    ct = tm.init_streaming_carry(3, torch.float32, "cpu")
    for i in range(4):
        hop = wav[:, i * HOP:(i + 1) * HOP]
        cj, _ = jm.streaming_step(jf, cj, jnp.asarray(hop))
        ct, _ = tm.streaming_step(tf, ct, torch.tensor(hop))
    assert_trees_close(ct["h"], cj["h"], atol=ATOL)


def test_fused_path_raises_on_more_than_one_frame():
    """The fused stack takes one frame per step. JAX's fused model_forward
    would run frame 0 only; the port raises."""
    _, tm = _models()
    tf = tm.fold(tm.init(torch.Generator().manual_seed(3), "cpu"))
    plan = tm.build_stack_plan(tf)
    carry = tm.init_streaming_carry(2, torch.float32, "cpu", fused=True)
    spec = torch.randn(2, tm.stft_cfg.n_freq - 1, 2, 2,
                       generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="T == 1"):
        tm.model_forward(tf["params"], tf["stats"], spec, h0=carry["h"],
                         fused_plan=plan)
    mask, _, _ = tm.model_forward(tf["params"], tf["stats"], spec[:, :, :1],
                                  h0=carry["h"], fused_plan=plan)
    assert mask.shape == (2, tm.stft_cfg.n_freq - 1, 1, 2)


def test_engine_slot_axes_and_a_reused_slot():
    """The engine finds the batch axis of every carry leaf (axis 0 of the
    [B, k_t-1, F, C] conv caches, axis 1 of the stacked GRU carries), and
    fused and unfused engines match isolated runs with a slot reused."""
    jm, tm = _models()
    _, tv = _variables(jm, 4)
    tf = tm.fold(tv)
    engine = StreamingEngine(tm, tf, capacity=3, fused=True, device="cpu")
    carry = engine._carry["h"]
    n_conv = len(carry["enc"]) + len(carry["dec"])
    # leaves in order: stft, istft, then h's "h", "enc", "dec"
    assert engine._axes[-n_conv - 1:] == [1] + [0] * n_conv
    check_engine_fused_matches_unfused(tm, tf, atol=ATOL)


def test_whole_frame_kernel_refuses_the_time_kernel_model():
    """The whole-frame kernel has no 2-D conv: the model's build_frame_plan
    (plan_frame) raises on the folded 4-D weights."""
    _, tm = _models()
    tf = tm.fold(tm.init(torch.Generator().manual_seed(5), "cpu"))
    with pytest.raises(ValueError, match="1-D convs only"):
        tm.build_frame_plan(tf)
    assert isinstance(get_model("fastenhancer.time_kernel", **KWARGS), TModel)
