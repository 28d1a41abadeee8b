"""PyTorch port of models/bsrnn.py and ops/bsrnn_stack.py against the JAX
package.

A tiny BSRNN (C=8, 2 layers; 31 bands, n_fft 512) with JAX weights moved
across by the bridge. The plan against the Pallas plan key by key, the
stack's plain version against the Pallas kernel in interpret mode (as
tests/test_ops_pallas.py runs it), and the model's fold, eval forward,
streaming step and fused stream against JAX. The CUDA kernel itself is
tested on the card by tests/test_torch_cuda_kernels.py.

Tolerances: 1e-5 absolute on trees, stack outputs and spectra (float32,
sums of at most a few hundred terms of order 1); 1e-4 on stream outputs
(float32 over several frames of recurrence and an iSTFT); bfloat16 against
the Pallas kernel 2^-5 of the largest magnitude (a few bf16 ulps: a sum on
a rounding boundary can round either way).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.bsrnn import Model as JModel
from fastenhancer_tpu.ops import bsrnn_stack as jstack
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.bsrnn import Model as TModel
from fastenhancer_tpu_torch.ops import bsrnn_stack as tstack
from fastenhancer_tpu_torch.presets import BSRNN_S

from _torch_parity import (as_np, assert_trees_close,
                           check_engine_fused_matches_unfused,
                           check_train_forward_runs, flatten_paths,
                           perturb_bn_stats, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5
HOP = 256
KW = dict(num_channels=8, num_layers=2, stft_method="matmul")


def _models(**over):
    kw = dict(KW, **over)
    return JModel(**kw), TModel(**kw)


@functools.lru_cache(maxsize=None)
def _jax_variables(folded):
    """The tiny model's JAX variables with random BN stats, made once per
    file (the eager JAX init of 31 bands takes seconds), folded or not."""
    jm = JModel(**KW)
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(0)), 0))
    return jm.fold(jv) if folded else jv


def _variables(folded=False):
    """JAX variables and the port's copy."""
    jv = _jax_variables(folded)
    return jv, port_variables(jv)


def _wav(b, frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * frames)) * 0.1).astype(np.float32)


def test_init_tree_matches_jax():
    """Same paths and shapes as the JAX init (bias=False: affine-less
    mask-decoder norms), identity BatchNorm, and the BSRNN-S preset at the
    JAX init's 3,541,580 parameters."""
    jm, tm = _models(bias=False)
    j = flatten_paths(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        if j[path] is None:
            assert t[path] is None, path
            continue
        assert tuple(t[path].shape) == j[path].shape, path
        if path[-1] in ("mean", "var"):
            assert torch.all(t[path] == (path[-1] == "var")), path
    w = t[("params", "layers", "1", "rnn_freq", "bwd", "weight_hh")]
    assert w.abs().max() <= 1 / 16 ** 0.5  # U(+-1/sqrt(hidden))
    full = get_model("bsrnn", **BSRNN_S).init(torch.Generator().manual_seed(0),
                                              "cpu")
    assert sum(a.numel() for a in flatten_paths(full["params"]).values()
               if a is not None) == 3_541_580


def test_fold_and_plan_match_jax():
    jm, tm = _models()
    jv, tv = _variables()
    jf, tf = _jax_variables(True), tm.fold(tv)
    assert_trees_close(tf, jf, atol=ATOL)
    jp, tp_ = jm.build_stack_plan(jf), tm.build_stack_plan(tf)
    assert tuple(tp_) == tstack.PLAN_KEYS
    for k in jstack._PLAN_KEYS:
        assert tuple(tp_[k].shape) == np.asarray(jp[k]).shape, k
        np.testing.assert_allclose(as_np(tp_[k]), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
    bf = tm.build_stack_plan(tf, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
    with pytest.raises(ValueError, match="fold"):
        tm.build_stack_plan(tv)


def _stack_inputs(tm, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tm.n_bands, b, tm.channels)).astype(np.float32)
    h = (rng.standard_normal((tm.num_layers, 2, tm.n_bands, b,
                              2 * tm.channels)) * 0.5).astype(np.float32)
    return x, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stack_matches_pallas(dtype):
    """B=3 (no aligned tile on a TPU; the port takes any batch), carries
    non-zero, f32 and the bf16 cast points."""
    jm, tm = _models()
    jf, tf = _variables(folded=True)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, h = _stack_inputs(tm, 3, 2)
    xj, hj = jstack.bsrnn_stack_step(jm.build_stack_plan(jf, jdt),
                                     jnp.asarray(x, jdt), jnp.asarray(h, jdt),
                                     interpret=True)
    before = tstack.bsrnn_stack_step.launches
    xt, ht = tstack.bsrnn_stack_step(tm.build_stack_plan(tf, tdt),
                                     torch.tensor(x).to(tdt),
                                     torch.tensor(h).to(tdt))
    assert tstack.bsrnn_stack_step.launches == before  # the CPU launches none
    assert xt.dtype == ht.dtype == tdt
    for got, want in ((xt, xj), (ht, hj)):
        want = np.asarray(want, np.float32)
        tol = ATOL if dtype == "float32" else 2.0 ** -5 * np.abs(want).max()
        np.testing.assert_allclose(as_np(got), want, atol=tol)


@pytest.mark.parametrize("folded", [False, True])
def test_forward_and_streaming_step_match_jax(folded):
    """The offline eval forward, and the per-hop streaming_step over 4
    frames with the (h, c) carries fed back on both sides."""
    jm, tm = _models()
    jv, tv = _variables(folded)
    wav = _wav(2, 4, 3)
    forward_j = jax.jit(functools.partial(jm.forward, train=False))
    wj, sj, _ = forward_j(jv, jnp.asarray(wav))
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
    for (hj, c_j), (ht, c_t) in zip(cj["h"], ct["h"]):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)
    check_train_forward_runs(tm, tv, torch.tensor(wav),
                             moves_stats=not folded)


def test_fused_stream_matches_jax_and_unfused():
    """stream(fused_plan=...) through the stack's plain version against
    JAX's Pallas-fused stream and the port's unfused stream."""
    jm, tm = _models()
    jf, tf = _variables(folded=True)
    wav = _wav(2, 5, 4)
    y_j = np.asarray(jm.stream(jf, jnp.asarray(wav),
                               fused_plan=jm.build_stack_plan(jf)))
    y_fused = tm.stream(tf, torch.tensor(wav),
                        fused_plan=tm.build_stack_plan(tf)).numpy()
    y_plain = tm.stream(tf, torch.tensor(wav)).numpy()
    np.testing.assert_allclose(y_fused, y_j, atol=1e-4)
    np.testing.assert_allclose(y_fused, y_plain, atol=ATOL)
    # a plan takes one frame a step; chunked streaming runs unfused
    with pytest.raises(ValueError, match="fused_plan"):
        tm.stream(tf, torch.tensor(wav), chunk_frames=2,
                  fused_plan=tm.build_stack_plan(tf))
    np.testing.assert_allclose(
        tm.stream(tf, torch.tensor(wav), chunk_frames=2).numpy(),
        y_plain[:, :tm.hop_size * 4], atol=1e-4)


def test_engine_fused_matches_unfused_with_a_reused_slot():
    _, tm = _models()
    check_engine_fused_matches_unfused(tm, _variables(folded=True)[1],
                                       atol=ATOL)


def test_wrapper_checks_and_shared_memory():
    """Bad operands raise before anything runs; BSRNN-XT, -T and -S fit one
    thread block's shared memory (227 KB)."""
    _, tm = _models()
    _, tf = _variables(folded=True)
    plan = tm.build_stack_plan(tf)
    x, h = (torch.tensor(a) for a in _stack_inputs(tm, 2, 6))
    with pytest.raises(ValueError, match="bfloat16|dtype"):
        tstack.bsrnn_stack_step(plan, x, h.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        tstack.bsrnn_stack_step(plan, x, h[:, :, :, :1])
    with pytest.raises(ValueError, match="shape"):
        tstack.bsrnn_stack_step(plan, x[:, :, :4].contiguous(), h)
    with pytest.raises(ValueError, match="contiguous"):
        tstack.bsrnn_stack_step(plan, x.transpose(0, 1).contiguous()
                                .transpose(0, 1), h)
    for c in (16, 32, 64):
        assert tstack.smem_bytes(31, c, 2 * c) <= tstack.MAX_SMEM_BYTES
