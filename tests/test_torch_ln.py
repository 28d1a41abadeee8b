"""PyTorch port of models/fastenhancer/ln.py (the ln ablation) against the
JAX package.

The tiny ln model of tests/test_ops_pallas.py (2 blocks, C'=8, F'=8,
n_fft 128), with non-trivial GroupNorm and LayerNorm affine params so that
the reference's `diff + inv * weight * bias` quirk matters, moved across by
the bridge. The JAX fused stream runs the Pallas stack kernel in interpret
mode. Tolerances (float32): 1e-5 on trees, specs and masks; 1e-5 on stream
outputs.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.ln import Model as JModel
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models.fastenhancer.ln import Model as TModel
from fastenhancer_tpu_torch.ops import fused_frame

from _torch_parity import (TINY_KWARGS, assert_trees_close,
                           check_engine_fused_matches_unfused,
                           check_train_forward_runs, flatten_paths,
                           perturb_norms, port_variables, to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HOP = TINY_KWARGS["hop_size"]
N_FRAMES = 12
ATOL = 1e-5


def _models(freq=8):
    kw = dict(TINY_KWARGS)
    kw["rnnformer_kwargs"] = dict(kw["rnnformer_kwargs"], freq=freq)
    return JModel(**kw), TModel(**kw)


def _variables(jm, seed):
    jv = jm.init(jax.random.PRNGKey(seed))
    jv = {"params": perturb_norms(jv["params"], seed), "stats": jv["stats"]}
    return jv, port_variables(jv)


def _wav(b, seed, frames=N_FRAMES):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * frames)) * 0.3).astype(np.float32)


def test_init_tree_matches_jax():
    """Same paths and shapes as the JAX init (GroupNorm units with the
    per-site conv biases, LayerNorm post-norms, no statistics), identity
    norms, and the absolute-Hz filterbanks equal."""
    jm, tm = _models()
    j = flatten_paths(to_np_tree(jm.init(jax.random.PRNGKey(0))))
    t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path in j:
        if j[path] is None:
            assert t[path] is None, path
            continue
        assert tuple(t[path].shape) == j[path].shape, path
    assert ("params", "decoder", "0", "gn2", "bias") in t
    assert ("params", "decoder", "0", "conv2", "bias") not in t
    for path in (("params", "rf_pre", "lin", "weight"),
                 ("params", "rf_post", "lin", "weight"),
                 ("params", "rf_blocks", "1", "attn_post_norm", "ln",
                  "weight"),
                 ("params", "enc_pre", "gn", "bias")):
        np.testing.assert_allclose(t[path].numpy(), j[path], atol=1e-7)


def test_fold_and_forward_match_jax():
    """fold (weight norm and the final scale stripped, every norm kept),
    and the offline forward on unfolded and folded variables."""
    jm, tm = _models()
    jv, tv = _variables(jm, 1)
    jf, tf = jm.fold(jv), tm.fold(tv)
    assert_trees_close(tf, jf, atol=ATOL)
    wav = _wav(2, 1)
    for j_vars, t_vars in ((jv, tv), (jf, tf)):
        wj, sj, _ = jm.forward(j_vars, jnp.asarray(wav), train=False)
        wt, st, _ = tm.forward(t_vars, torch.tensor(wav))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ATOL)
    check_train_forward_runs(tm, tv, torch.tensor(wav), moves_stats=False)


@pytest.mark.parametrize("freq", [8, 10])
def test_stream_unfused_and_fused_match_jax(freq):
    """stream() on folded variables, unfused against JAX's XLA stream and
    fused (the LN form's plain version) against JAX's Pallas-fused stream;
    F'=10 makes the Pallas kernel pad the frequency rows and mask them out
    of the LayerNorm statistics."""
    jm, tm = _models(freq)
    jv, tv = _variables(jm, 2)
    jf, tf = jm.fold(jv), tm.fold(tv)
    wav = _wav(2, 2)
    y_j = np.asarray(jm.stream(jf, jnp.asarray(wav)))
    y_j_fused = np.asarray(jm.stream(jf, jnp.asarray(wav),
                                     fused_plan=jm.build_stack_plan(jf)))
    plan = tm.build_stack_plan(tf)
    assert plan["ln_eps"] == tm.rf.eps
    y_t = tm.stream(tf, torch.tensor(wav)).numpy()
    y_t_fused = tm.stream(tf, torch.tensor(wav), fused_plan=plan).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)
    np.testing.assert_allclose(y_t_fused, y_j_fused, atol=ATOL)
    np.testing.assert_allclose(y_t_fused, y_t, atol=ATOL)


def test_engine_fused_matches_unfused_with_a_reused_slot():
    jm, tm = _models()
    _, tv = _variables(jm, 3)
    check_engine_fused_matches_unfused(tm, tm.fold(tv), atol=ATOL)


def test_whole_frame_kernel_refuses_the_ln_model():
    """The whole-frame kernel has no GroupNorm or LayerNorm: plan_frame
    raises on a folded ln tree, whose empty statistics pass its fold check,
    and so does the model's build_frame_plan."""
    jm, tm = _models()
    _, tv = _variables(jm, 4)
    tf = tm.fold(tv)
    with pytest.raises(ValueError, match="GroupNorm or LayerNorm"):
        tm.build_frame_plan(tf)
    with pytest.raises(ValueError, match="GroupNorm or LayerNorm"):
        fused_frame.plan_frame(tm, tf)


def test_stack_plan_options_registry_and_torch_names():
    """build_stack_plan raises on post_act and pre_norm recipes and on
    unfolded (weight-normed) variables; the registry returns the port's
    model; torch_name maps every param path as the JAX model does."""
    jm, tm = _models()
    jv, tv = _variables(jm, 5)
    with pytest.raises(ValueError, match="fold"):
        tm.build_stack_plan(tv)
    for opt in ("post_act", "pre_norm"):
        kw = dict(TINY_KWARGS)
        kw["rnnformer_kwargs"] = dict(kw["rnnformer_kwargs"], **{opt: True})
        m = TModel(**kw)
        with pytest.raises(NotImplementedError, match=opt):
            m.build_stack_plan(m.fold(m.init(torch.Generator(), "cpu")))
    assert isinstance(get_model("fastenhancer.ln", **TINY_KWARGS), TModel)
    for path, leaf in flatten_paths(tv["params"]).items():
        if leaf is not None:
            assert tm.torch_name(path) == jm.torch_name(path), path
