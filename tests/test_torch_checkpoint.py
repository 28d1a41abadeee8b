"""Checkpoints: the port's save and load, and resume across the two
packages in both directions.

The file format is the JAX package's (train/checkpoint.py): a pickle of
numpy trees, the optimizer state as {"m", "v", "step"} with None at frozen
leaves. Loading writes into the live leaves that the optimizer holds, so a
step after a save and a load equals a step without them, bit for bit. Across
packages a step runs in another order of float32 operations: the
tolerances are tests/test_torch_train.py's for one step from equal
variables (losses rtol 1e-5, params and statistics 1e-5; the two biases
whose gradient is zero in exact arithmetic 3x the learning rate).
"""
import copy
import os
import pickle

import numpy as np
import pytest

from fastenhancer_tpu.train.checkpoint import load_checkpoint as jload
from fastenhancer_tpu.utils.hparams import HParams as JHParams
from fastenhancer_tpu.wrappers import get_wrapper as jget_wrapper
from fastenhancer_tpu_torch.presets import FE_T_SHARD
from fastenhancer_tpu_torch.train import latest_checkpoint, load_checkpoint
from fastenhancer_tpu_torch.train.checkpoint import clean_checkpoints
from fastenhancer_tpu_torch.utils import tree_paths
from fastenhancer_tpu_torch.utils.hparams import HParams
from fastenhancer_tpu_torch.wrappers import get_wrapper

from _torch_parity import (TINY_KWARGS, flatten_paths,
                           real_triton_only,  # noqa: F401
                           to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

HOP = TINY_KWARGS["hop_size"]
DEAD = {("rf_post", "bn", "bias"), ("rf_blocks", "1", "attn_post_norm",
                                    "bias")}


def _hps(base_dir, seed=1):
    """The shard recipe's train section on the tiny model, float32, the
    `ns` wrapper, a 2-iteration warmup (steps at lr 1e-3 and 2e-3)."""
    hps = copy.deepcopy(FE_T_SHARD)
    hps["model_kwargs"] = dict(TINY_KWARGS)
    hps["wrapper"] = "ns"
    hps["train"].update(fp16=False, seed=seed)
    hps["train"]["scheduler_kwargs"]["warmup_iterations"] = 2
    hps["base_dir"] = str(base_dir)
    return hps


def _batch(seed, rows=3, frames=12):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((rows, HOP * frames)) * 0.1).astype(
        np.float32)
    noisy = clean + (rng.standard_normal(clean.shape) * 0.05).astype(
        np.float32)
    return {"clean": clean, "noisy": noisy}


def _port(base_dir, seed=1):
    return get_wrapper("ns")(HParams(**_hps(base_dir, seed)), train=True,
                             device="cpu")


def _state(w):
    """(params, stats, optimizer state tree, scheduler state) as numpy."""
    v = w.state["variables"]
    return ({p: t.numpy().copy() for p, t in tree_paths(v["params"])},
            {p: t.numpy().copy() for p, t in tree_paths(v["stats"])},
            w.optim.state_tree(v["params"]), w.scheduler.state_dict())


def _assert_state_equal(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=str(k))
    fa, fb = flatten_paths(a[2]), flatten_paths(b[2])
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k] is None:
            assert fb[k] is None, k
        else:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))
    assert a[3] == b[3]


@pytest.mark.parametrize("steps_before_save", [0, 2])
def test_save_load_is_bit_exact_and_binds_the_live_leaves(tmp_path,
                                                          steps_before_save):
    """A trains, saves; B (another seed, so another init) loads: its
    params, BN statistics, m, v, step and scheduler equal A's, bit for bit,
    and one more step on both stays equal (before the first step B's
    optimizer state dicts are empty, and load fills them)."""
    a = _port(tmp_path)
    if steps_before_save:
        a.train_epoch([_batch(s) for s in range(steps_before_save)])
    a.epoch = 3
    path = a.save(3)
    assert path == os.path.join(str(tmp_path), "00003.ckpt")
    assert not os.path.exists(path + ".tmp")
    b = _port(tmp_path, seed=7)
    key = ("encoder", "0", "conv", "weight")
    assert not np.array_equal(_state(a)[0][key], _state(b)[0][key])
    assert b.load() and b.epoch == 3
    _assert_state_equal(_state(b), _state(a))
    # the optimizer still holds the wrapper's live leaves
    leaves = {id(t) for _, t in tree_paths(b.state["variables"]["params"])}
    assert all(id(p) in leaves for g in b.optim.param_groups
               for p in g["params"])
    assert b._lrs() == a._lrs()
    sa = a.train_epoch([_batch(9)])
    sb = b.train_epoch([_batch(9)])
    assert sa == sb
    _assert_state_equal(_state(b), _state(a))
    step = int(_state(b)[2]["step"])
    assert step == steps_before_save + 1


def test_checkpoint_file_holds_numpy_only_and_files_rotate(tmp_path):
    w = _port(tmp_path)
    w.train_epoch([_batch(0)])
    for epoch in (1, 2, 10):
        w.save(epoch)
    assert latest_checkpoint(str(tmp_path)).endswith("00010.ckpt")
    with open(os.path.join(str(tmp_path), "00002.ckpt"), "rb") as f:
        raw = f.read()
    assert b"torch" not in raw
    ckpt = load_checkpoint(os.path.join(str(tmp_path), "00002.ckpt"))
    assert ckpt.keys() == {"variables", "opt_state", "scheduler", "epoch",
                           "metrics"}
    assert ckpt["epoch"] == 2 and ckpt["metrics"] is None
    for _, leaf in tree_paths(ckpt["variables"]) + tree_paths(
            ckpt["opt_state"]):
        assert isinstance(leaf, np.ndarray)
    assert ckpt["opt_state"]["step"].dtype == np.int32
    assert ckpt["opt_state"]["step"].shape == ()
    with pytest.raises(FileNotFoundError):
        w.load(epoch=4)
    assert w.load(epoch=1) and w.epoch == 1
    assert [os.path.basename(p) for p in clean_checkpoints(
        str(tmp_path), keep_last=1)] == ["00001.ckpt", "00002.ckpt"]
    assert not _port(tmp_path / "empty").load()


def _jax_wrapper(base_dir, seed=1):
    return jget_wrapper("ns")(JHParams(**_hps(base_dir, seed)), train=True)


def _assert_step_close(port_w, jax_w, port_summary, jax_summary):
    for k, v in jax_summary["scalars"].items():
        np.testing.assert_allclose(port_summary["scalars"][k], v,
                                   rtol=1e-5, err_msg=k)
    lr = max(jax_w.scheduler.lrs)
    jv = jax_w.state["variables"]
    jparams = flatten_paths(to_np_tree(jv["params"]))
    jstats = flatten_paths(to_np_tree(jv["stats"]))
    pv = port_w.state["variables"]
    for path, t in tree_paths(pv["params"]):
        tol = 1e-5 + (3 * lr if path in DEAD else 0.0)
        np.testing.assert_allclose(t.numpy(), jparams[path], atol=tol,
                                   rtol=0, err_msg=str(path))
    for path, t in tree_paths(pv["stats"]):
        np.testing.assert_allclose(t.numpy(), jstats[path], atol=1e-5,
                                   rtol=0, err_msg=str(path))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's wrapper trains 2 float32 steps and saves; the port loads it
    (bit for bit) and its next step matches JAX's third."""
    jw = _jax_wrapper(tmp_path)
    jw.train_epoch([_batch(0), _batch(1)])
    jw.save(1)
    pw = _port(tmp_path, seed=7)
    assert pw.load() and pw.epoch == 1
    ck = jload(os.path.join(str(tmp_path), "00001.ckpt"))
    params, stats, opt, sched = _state(pw)
    want_p = flatten_paths(ck["variables"]["params"])
    for path, a in params.items():
        np.testing.assert_array_equal(a, want_p[path], err_msg=str(path))
    want_s = flatten_paths(ck["variables"]["stats"])
    for path, a in stats.items():
        np.testing.assert_array_equal(a, want_s[path], err_msg=str(path))
    for key in ("m", "v"):
        fo, fj = flatten_paths(opt[key]), flatten_paths(ck["opt_state"][key])
        assert fo.keys() == fj.keys()
        for path in fj:
            if fj[path] is None:
                assert fo[path] is None
            else:
                np.testing.assert_array_equal(fo[path], fj[path])
    assert int(opt["step"]) == int(ck["opt_state"]["step"]) == 2
    assert pw._lrs() == list(jw.scheduler.lrs)
    _assert_step_close(pw, jw, pw.train_epoch([_batch(2)]),
                       jw.train_epoch([_batch(2)]))


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port trains 2 steps and saves; JAX's load_checkpoint reads a
    tree with the paths, None leaves, shapes and dtypes of JAX's own state
    and the port's values; JAX's wrapper resumes from it and its next step
    matches the port's."""
    pw = _port(tmp_path)
    pw.train_epoch([_batch(0), _batch(1)])
    pw.save(1)
    ck = jload(os.path.join(str(tmp_path), "00001.ckpt"))
    fresh = _jax_wrapper(tmp_path / "fresh")
    own = {"variables": to_np_tree(fresh.state["variables"]),
           "opt_state": to_np_tree(fresh.state["opt_state"])}
    for part in ("variables", "opt_state"):
        got, want = flatten_paths(ck[part]), flatten_paths(own[part])
        assert got.keys() == want.keys(), part
        for path in want:
            if want[path] is None:
                assert got[path] is None, path
                continue
            assert got[path].shape == want[path].shape, path
            assert got[path].dtype == want[path].dtype, path
    params, stats, opt, sched = _state(pw)
    assert ck["scheduler"] == sched
    got_p = flatten_paths(ck["variables"]["params"])
    for path, a in params.items():
        np.testing.assert_array_equal(got_p[path], a)
    jw = _jax_wrapper(tmp_path, seed=7)
    assert jw.load() and jw.epoch == 1
    jparams = flatten_paths(to_np_tree(jw.state["variables"]["params"]))
    for path, a in params.items():
        np.testing.assert_array_equal(jparams[path], a)
    assert int(jw.state["opt_state"]["step"]) == 2
    _assert_step_close(pw, jw, pw.train_epoch([_batch(2)]),
                       jw.train_epoch([_batch(2)]))


def test_load_refuses_a_mismatched_tree(tmp_path):
    w = _port(tmp_path)
    path = w.save(1)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    ckpt["variables"]["params"]["enc_pre"]["bn"]["bias"] = np.zeros(3)
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    with pytest.raises(ValueError, match="shape"):
        w.load()
    del ckpt["variables"]["params"]["enc_pre"]
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    with pytest.raises(ValueError, match="paths differ"):
        w.load()
    assert w.state["variables"]["params"]["enc_pre"]["bn"]["bias"].shape != (
        3,)
