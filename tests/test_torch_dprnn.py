"""PyTorch port of models/fastenhancer/dprnn.py and ops/dprnn_stack.py
against the JAX package.

The shrunk dprnn_t of tests/test_model_variants.py (DPRNN_KWARGS: C=16,
2 blocks, C'=12, C_frnn=6, F'=16, n_fft 512) with JAX weights moved across
by the bridge. The plan against the Pallas plan key by key, the stack's
plain version against the Pallas kernel in interpret mode (as
tests/test_ops_pallas.py runs it), and the model's fold, eval forward,
streaming step and fused stream against JAX. The CUDA kernel itself is
tested on the card by tests/test_torch_cuda_kernels.py.

Tolerances: 1e-5 absolute on trees, stack outputs and spectra (float32,
sums of at most a few hundred terms of order 1); 1e-4 on stream outputs
(float32 over several frames of recurrence and an iSTFT); bfloat16 against
the Pallas kernel 2^-5 of the largest magnitude (a few bf16 ulps).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.dprnn import Model as JModel
from fastenhancer_tpu.ops import dprnn_stack as jstack
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer.dprnn import Model as TModel
from fastenhancer_tpu_torch.ops import dprnn_stack as tstack
from fastenhancer_tpu_torch.presets import DPRNN_B

from _torch_parity import (as_np, assert_trees_close,
                           check_engine_fused_matches_unfused,
                           check_train_forward_runs, flatten_paths,
                           perturb_bn_stats, port_variables, to_np_tree,
                           torch_one_thread)  # noqa: F401
from test_model_variants import DPRNN_KWARGS

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5
HOP = DPRNN_KWARGS["hop_size"]
KW = dict(DPRNN_KWARGS, stft_method="matmul")
PRE_NORM = dict(KW, dprnn_kwargs=dict(KW["dprnn_kwargs"], pre_norm=True))


def _models(kw=KW):
    return JModel(**kw), TModel(**kw)


def _variables(jm, seed, folded=False):
    """JAX variables with random BN stats, and the port's copy."""
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)),
                                       seed))
    if folded:
        jv = jm.fold(jv)
    return jv, port_variables(jv)


def _wav(b, frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * frames)) * 0.1).astype(np.float32)


def test_init_tree_matches_jax():
    """Same paths and shapes as the JAX init; the absolute-Hz filterbanks
    equal; DPRNN-B builds at the JAX init's 102,099 parameters."""
    jm, tm = _models(PRE_NORM)
    j = flatten_paths(to_np_tree(jm.init(jax.random.PRNGKey(0))))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        assert tuple(t[path].shape) == j[path].shape, path
    for path in (("params", "rf_pre", "lin", "weight"),
                 ("params", "rf_post", "lin", "weight"),
                 ("params", "dec_post", "convt", "scale")):
        np.testing.assert_allclose(t[path].numpy(), j[path], atol=1e-7)
    full = get_model("fastenhancer.dprnn", **DPRNN_B)
    leaves = flatten_paths(full.init(torch.Generator().manual_seed(0),
                                     "cpu")["params"]).values()
    assert sum(a.numel() for a in leaves if a is not None) == 102_099


@pytest.mark.parametrize("kw", [KW, PRE_NORM], ids=["plain", "pre_norm"])
def test_fold_and_plan_match_jax(kw):
    jm, tm = _models(kw)
    jv, tv = _variables(jm, 1)
    jf, tf = jm.fold(jv), tm.fold(tv)
    assert_trees_close(tf, jf, atol=ATOL)
    jp, tp_ = jm.build_stack_plan(jf), tm.build_stack_plan(tf)
    assert tuple(tp_) == tstack.PLAN_KEYS == jstack._PLAN_KEYS
    for k in tstack.PLAN_KEYS:
        assert tuple(tp_[k].shape) == np.asarray(jp[k]).shape, k
        np.testing.assert_allclose(as_np(tp_[k]), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="fold"):
        tm.build_stack_plan(tv)


def _stack_inputs(tm, b, seed):
    rng = np.random.default_rng(seed)
    dp = tm.dp
    x = rng.standard_normal((dp.freq, b, dp.channels)).astype(np.float32)
    h = (rng.standard_normal((dp.num_blocks, dp.freq, b, dp.channels))
         * 0.5).astype(np.float32)
    return x, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stack_matches_pallas(dtype):
    """B=3 (no aligned tile on a TPU; the port takes any batch), carries
    non-zero, f32 and the bf16 cast points."""
    jm, tm = _models()
    jf, tf = _variables(jm, 2, folded=True)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, h = _stack_inputs(tm, 3, 2)
    xj, hj = jstack.dprnn_stack_step(jm.build_stack_plan(jf, jdt),
                                     jnp.asarray(x, jdt), jnp.asarray(h, jdt),
                                     interpret=True)
    before = tstack.dprnn_stack_step.launches
    xt, ht = tstack.dprnn_stack_step(tm.build_stack_plan(tf, tdt),
                                     torch.tensor(x).to(tdt),
                                     torch.tensor(h).to(tdt))
    assert tstack.dprnn_stack_step.launches == before  # the CPU launches none
    assert xt.dtype == ht.dtype == tdt
    for got, want in ((xt, xj), (ht, hj)):
        want = np.asarray(want, np.float32)
        tol = ATOL if dtype == "float32" else 2.0 ** -5 * np.abs(want).max()
        np.testing.assert_allclose(as_np(got), want, atol=tol)


@pytest.mark.parametrize("folded", [False, True])
def test_forward_and_streaming_step_match_jax(folded):
    """The offline eval forward, and the per-hop streaming_step over 4
    frames with the GRU carries fed back on both sides."""
    jm, tm = _models()
    jv, tv = _variables(jm, 3, folded)
    wav = _wav(2, 4, 3)
    wj, sj, _ = jax.jit(functools.partial(jm.forward, train=False))(
        jv, jnp.asarray(wav))
    wt, st, _ = tm.forward(tv, torch.tensor(wav))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    cj = jm.init_streaming_carry(2)
    ct = tm.init_streaming_carry(2, torch.float32, "cpu")
    step_j = jax.jit(jm.streaming_step)
    for i in range(4):
        hop = wav[:, i * HOP:(i + 1) * HOP]
        cj, yj = step_j(jv, cj, jnp.asarray(hop))
        ct, yt = tm.streaming_step(tv, ct, torch.tensor(hop))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
    for hj, ht in zip(cj["h"], ct["h"]):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4)
    check_train_forward_runs(tm, tv, torch.tensor(wav),
                             moves_stats=not folded)


def test_fused_stream_matches_jax_and_unfused():
    """stream(fused_plan=...) through the stack's plain version against
    JAX's Pallas-fused stream and the port's unfused stream; the fused
    carry's layout."""
    jm, tm = _models(PRE_NORM)
    jf, tf = _variables(jm, 4, folded=True)
    wav = _wav(3, 5, 4)
    y_j = np.asarray(jm.stream(jf, jnp.asarray(wav),
                               fused_plan=jm.build_stack_plan(jf)))
    y_fused = tm.stream(tf, torch.tensor(wav),
                        fused_plan=tm.build_stack_plan(tf)).numpy()
    y_plain = tm.stream(tf, torch.tensor(wav)).numpy()
    np.testing.assert_allclose(y_fused, y_j, atol=1e-4)
    np.testing.assert_allclose(y_fused, y_plain, atol=ATOL)
    carry = tm.init_streaming_carry(3, torch.float32, "cpu", fused=True)
    assert tuple(carry["h"].shape) == tuple(
        np.asarray(jm.init_streaming_carry(3, fused=True)["h"]).shape)


def test_engine_fused_matches_unfused_with_a_reused_slot():
    jm, tm = _models()
    check_engine_fused_matches_unfused(
        tm, _variables(jm, 5, folded=True)[1], atol=ATOL)


def test_wrapper_checks_and_shared_memory():
    """Bad operands raise before anything runs; DPRNN T/B/S/M/L fit one
    thread block's shared memory."""
    jm, tm = _models()
    _, tf = _variables(jm, 6, folded=True)
    plan = tm.build_stack_plan(tf)
    x, h = (torch.tensor(a) for a in _stack_inputs(tm, 2, 6))
    with pytest.raises(ValueError, match="bfloat16|dtype"):
        tstack.dprnn_stack_step(plan, x, h.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        tstack.dprnn_stack_step(plan, x, h[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tstack.dprnn_stack_step(plan, x[:, :, :4].contiguous(), h)
    with pytest.raises(ValueError, match=r"\[F, B, C\]"):
        tstack.dprnn_stack_step(plan, x[0], h)
    for f, c in ((16, 20), (24, 36), (36, 48), (48, 72), (64, 96)):
        assert tstack.smem_bytes(f, c, c // 2) <= tstack.MAX_SMEM_BYTES
