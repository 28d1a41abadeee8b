"""The training path against the JAX package: train-mode BatchNorm with a
row mask, the tiny FastEnhancer's forward(train=True), three float32 train
steps and a valid step against make_train_step / make_valid_step (no mesh),
and the shard wrapper end to end on the CPU.

Tolerances (float32): BatchNorm 1e-5; forward outputs and new statistics
1e-5 (spec) and 1e-4 (wav, after the iSTFT); losses rtol 1e-5 and the
grad norm rtol 1e-4 (a sum over every gradient, taken after the params
have moved apart by up to 1e-5); params 1e-5 after every step, except on
the leaves whose gradient is zero in exact arithmetic (the JAX gradient
below 1e-6: biases that reach a train-mode BatchNorm through linear
layers only, such as rf_post's BN bias). There both sides get float32 noise of about 1e-9, which Adam turns
into a step of either sign, so those leaves are held to 3x the sum of the
learning rates; the running means of the BNs after them inherit that
drift, so running means are held to 1e-5 after the first step and to
1e-3 after later ones (running variances stay at 1e-5).
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.losses import Losses as JLosses
from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu.nn.layers import batch_norm as jbatch_norm
from fastenhancer_tpu.optim import get_optimizer as jget_optimizer
from fastenhancer_tpu.optim import get_scheduler as jget_scheduler
from fastenhancer_tpu.train import make_train_step as jmake_train_step
from fastenhancer_tpu.train import make_clipper as jmake_clipper
from fastenhancer_tpu.train import make_valid_step as jmake_valid_step
from fastenhancer_tpu_torch import nn as fnn
from fastenhancer_tpu_torch.data import ShardBatch
from fastenhancer_tpu_torch.losses import Losses
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.optim import get_optimizer, get_scheduler
from fastenhancer_tpu_torch.presets import FE_T_SHARD
from fastenhancer_tpu_torch.train import (make_clipper, make_infer_fn,
                                          make_train_step, make_valid_step)
from fastenhancer_tpu_torch.serving import StreamingEngine
from fastenhancer_tpu_torch.utils import tree_leaves, tree_paths
from fastenhancer_tpu_torch.utils.hparams import HParams
from fastenhancer_tpu_torch.wrappers import get_wrapper

from _torch_parity import (TINY_KWARGS, assert_trees_close, flatten_paths,
                           perturb_bn_stats, port_variables,
                           real_triton_only,  # noqa: F401
                           to_np_tree,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

HOP = TINY_KWARGS["hop_size"]
ROW_MASK = np.array([1, 1, 0], np.float32)


def _hp_train():
    """The shard recipe's train section on the tiny model: its losses
    (consistency at the tiny STFT, as the wrapper fills it in), AdamP and
    groups, with a 2-iteration warmup so the steps run at lr 1e-3 to 2e-3
    and every param moves."""
    hp = copy.deepcopy(FE_T_SHARD["train"])
    hp["losses"]["consistency"].update(n_fft=128, hop_size=HOP, win_size=128,
                                       win_type="hann")
    hp["scheduler_kwargs"]["warmup_iterations"] = 2
    return hp


def _batch(seed, rows=3, frames=12, pad_last=True):
    """clean/noisy numpy rows; with pad_last the last row is zeros, as a
    row padded to fill a batch."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((rows, HOP * frames)) * 0.1).astype(
        np.float32)
    noisy = clean + (rng.standard_normal(clean.shape) * 0.05).astype(
        np.float32)
    if pad_last:
        clean[-1] = noisy[-1] = 0.0
    return {"clean": clean, "noisy": noisy}


@pytest.mark.parametrize("masked", [False, True])
def test_batch_norm_train_matches_jax(masked):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    p = {"weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    s = {"mean": rng.standard_normal(6).astype(np.float32),
         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    w = ROW_MASK[:, None, None, None] if masked else None
    yj, sj = jbatch_norm({k: jnp.asarray(v) for k, v in p.items()},
                         {k: jnp.asarray(v) for k, v in s.items()},
                         jnp.asarray(x), train=True,
                         weight=None if w is None else jnp.asarray(w))
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    yt, st = fnn.batch_norm(t(p), t(s), torch.from_numpy(x), train=True,
                            weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   atol=1e-5)
    # bf16 activations: float32 statistics, output in bf16
    yb, sb = fnn.batch_norm(t(p), t(s), torch.from_numpy(x).bfloat16(),
                            train=True)
    assert yb.dtype == torch.bfloat16 and sb["mean"].dtype == torch.float32


@pytest.mark.parametrize("mode,kwargs", [
    (None, None), ("norm", {"max_norm": 1.0}),
    ("norm_global", {"max_norm": 50.0}), ("norm_local", {"max_norm": 0.5}),
    ("value", {"clip_value": 0.3})])
def test_clippers_match_jax(mode, kwargs):
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    jg, jn = jmake_clipper(mode, kwargs)(jax.tree.map(jnp.asarray, tree))
    tg, tn = make_clipper(mode, kwargs)(
        {"a": torch.from_numpy(tree["a"]),
         "b": [torch.from_numpy(tree["b"][0])]})
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert_trees_close(tg, jg, atol=1e-6)


def _models():
    return JModel(**TINY_KWARGS), TModel(**TINY_KWARGS)


def test_forward_train_matches_jax():
    """forward(train=True, row_mask=[1, 1, 0]) on a batch whose last row
    is padding: outputs and every new BN statistic agree with JAX, and the
    padded row changes no statistic."""
    jm, tm = _models()
    jv = jm.init(jax.random.PRNGKey(1))
    tv = port_variables(jv)
    noisy = _batch(1)["noisy"]
    wj, sj, stj = jm.forward(jv, jnp.asarray(noisy), train=True,
                             row_mask=jnp.asarray(ROW_MASK))
    wt, st, stt = tm.forward(tv, torch.from_numpy(noisy), train=True,
                             row_mask=torch.from_numpy(ROW_MASK))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    assert_trees_close(stt, stj, atol=1e-5)
    # the same two real rows alone give the same statistics
    _, _, two = tm.forward(tv, torch.from_numpy(noisy[:2]), train=True)
    assert_trees_close(two, stj, atol=1e-5)
    assert tm._row_mask is None


def test_train_steps_match_jax():
    """Three float32 train steps of the tiny FE with the shard recipe's
    losses, AdamP groups and warmup, on a batch with a padded row: loss,
    every item loss, grad norm, every param and every BN statistic after
    each step (tolerances in the module docstring)."""
    hp = _hp_train()
    jm, tm = _models()
    jv = jm.init(jax.random.PRNGKey(2))
    tv = port_variables(jv)
    jlos, tlos = JLosses(hp["losses"]), Losses(hp["losses"])
    jo = jget_optimizer(jm, jv["params"], hp)
    to = get_optimizer(tm, tv["params"], hp)
    jsched, tsched = jget_scheduler(jo, hp), get_scheduler(to, hp)
    jstep = jmake_train_step(jm, jlos, jo, donate=False, return_grads=True)
    tstep = make_train_step(tm, tlos, to)
    jstate = {"variables": jv, "opt_state": jo.init(jv["params"])}
    tstate = {"variables": tv}
    batch = dict(_batch(2), row_mask=ROW_MASK)
    dead, sum_lr = set(), 0.0
    for step in range(3):
        assert tsched.lrs == jsched.lrs
        lrs = list(jsched.lrs)
        sum_lr += max(lrs)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                            jnp.asarray(lrs, jnp.float32))
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, lrs)
        jsched.warmup_step()
        tsched.warmup_step()
        grads = flatten_paths(to_np_tree(jm_.pop("grads")))
        assert tm_.keys() == jm_.keys()
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-4 if k == "grad_norm" else 1e-5,
                                       err_msg=f"{k} {step}")
        jparams = flatten_paths(to_np_tree(jstate["variables"]["params"]))
        for path, leaf in tree_paths(tstate["variables"]["params"]):
            if np.abs(grads[path]).max() < 1e-6:
                dead.add(path)
            tol = 1e-5 + (3 * sum_lr if path in dead else 0.0)
            np.testing.assert_allclose(leaf.detach().numpy(), jparams[path],
                                       atol=tol, rtol=0,
                                       err_msg=f"{path} step {step}")
        jstats = flatten_paths(to_np_tree(jstate["variables"]["stats"]))
        for path, leaf in tree_paths(tstate["variables"]["stats"]):
            tol = 1e-5 if step == 0 or path[-1] == "var" else 1e-3
            np.testing.assert_allclose(leaf.numpy(), jstats[path], atol=tol,
                                       rtol=0, err_msg=f"{path} {step}")
    # only the leaves that are dead in exact arithmetic took the wide bound
    assert dead == {("rf_post", "bn", "bias"),
                    ("rf_blocks", "1", "attn_post_norm", "bias")}


def test_valid_step_and_infer_match_jax():
    hp = _hp_train()
    jm, tm = _models()
    jv = jm.init(jax.random.PRNGKey(3))
    tv = port_variables(jv)
    batch = dict(_batch(3), row_mask=ROW_MASK)
    want = jmake_valid_step(jm, JLosses(hp["losses"]))(
        jv, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_valid_step(tm, Losses(hp["losses"]))(
        tv, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    wav = make_infer_fn(tm)(tv, torch.from_numpy(batch["noisy"]))
    wj, _, _ = jm.forward(jv, jnp.asarray(batch["noisy"]))
    np.testing.assert_allclose(wav.numpy(), np.asarray(wj), atol=1e-4)


def test_valid_step_bf16_matches_jax():
    """bfloat16 compute over float32 variables: the port's valid step against
    JAX's on the same variables (random BN statistics) and batch (a padded
    row masked out). The two round to bfloat16 at different points (the
    port's eval time GRU keeps its state in float32 over the frames, JAX's
    rounds it every step), so the losses, means over thousands of bf16
    values, differ by a small fraction of a bf16 unit roundoff (2^-9):
    measured at most 6.5e-5 relative here (1.4e-4 over seeds 3-7, FE-T at
    4 x 1 s up to 1.2e-4). Tolerance: rtol 5e-4 on every loss. The control,
    the port's valid step in float32 (compute_dtype ignored), is off by
    2.9e-3 on this seed (at least 1.2e-3 over seeds 3-7), so the test
    also asserts that the float32 step fails the same limit."""
    hp = _hp_train()
    jm, tm = _models()
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(3)), 3))
    tv = port_variables(jv)
    batch = dict(_batch(3, rows=4, frames=16),
                 row_mask=np.array([1, 1, 1, 0], np.float32))
    want = jmake_valid_step(jm, JLosses(hp["losses"]),
                            compute_dtype=jnp.bfloat16)(
        jv, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = make_valid_step(tm, Losses(hp["losses"]),
                          compute_dtype=torch.bfloat16)(tv, tb)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=5e-4,
                                   err_msg=k)
    f32 = make_valid_step(tm, Losses(hp["losses"]))(tv, tb)
    assert max(abs(float(f32[k]) / float(want[k]) - 1) for k in want) > 5e-4


def test_trained_variables_serve_untracked():
    """After a train epoch the wrapper's params leave untracked, and so do
    fold()'s outputs: the engine serves them and stream() builds no
    graph."""
    hps = copy.deepcopy(FE_T_SHARD)
    hps["model_kwargs"] = dict(TINY_KWARGS)
    hps["train"].update(fp16=False, test=True)
    wrapper = get_wrapper("ns")(HParams(**hps), train=True, device="cpu")
    wrapper.train_epoch([_batch(8, pad_last=False)])
    variables = wrapper.state["variables"]
    assert not any(t.requires_grad for t in tree_leaves(variables))
    model = wrapper.model
    folded = model.fold(variables)
    assert not any(t.requires_grad for t in tree_leaves(folded))
    wav = torch.from_numpy(_batch(9, rows=2, pad_last=False)["noisy"])
    for plan in (None, model.build_stack_plan(folded)):
        y = model.stream(folded, wav, fused_plan=plan)
        assert not y.requires_grad and torch.isfinite(y).all()
    engine = StreamingEngine(model, folded, capacity=2, fused=True,
                             device="cpu")
    h = engine.open_stream()
    out = engine.tick({h: wav[0, :HOP].numpy()})[h]
    assert out.shape == (HOP,) and np.isfinite(out).all()


def test_nonfinite_step_keeps_the_state():
    hp = _hp_train()
    tm = TModel(**TINY_KWARGS)
    tv = tm.init(torch.Generator().manual_seed(0), "cpu")
    before = {p: t.clone() for p, t in tree_paths(tv)}
    los = Losses(hp["losses"])
    step = make_train_step(tm, los, get_optimizer(tm, tv["params"], hp),
                           skip_nonfinite=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    batch["noisy"][0, 5] = float("nan")
    state, metrics = step({"variables": tv}, batch, [1e-3] * 16)
    assert float(metrics["skipped"]) == 1.0
    for p, t in tree_paths(state["variables"]):
        assert torch.equal(t, before[p]), p


def _shard_batch(seed, rows, t, t_rir):
    """A synthetic ShardBatch: speech with silent stretches, noise with one
    silent row, unit-impulse RIRs on half the rows and decaying noise (t60
    above and below t60_max) on the others."""
    rng = np.random.default_rng(seed)
    speech = (rng.standard_normal((rows, 1, t)) * 0.1).astype(np.float32)
    speech[:, :, t // 3: t // 2] = 0.0
    noise = (rng.standard_normal((rows, 1, t)) * 0.05).astype(np.float32)
    noise[0] = 0.0
    rir = np.zeros((rows, 1, t_rir), np.float32)
    rir[:, 0, 0] = 1.0
    onset = np.zeros(rows, np.int64)
    t60 = np.full(rows, 1e-3, np.float32)
    n = np.arange(t_rir)
    for i in range(rows // 2, rows):
        t60[i] = 0.1 if i % 2 else 0.4
        r = rng.standard_normal(t_rir) * np.exp(-6.9 * n / (t60[i] * 16000))
        rir[i, 0] = (r / np.abs(r).max()).astype(np.float32)
    return ShardBatch(speech=speech, speech_clean=speech.copy(), noise=noise,
                      rir=rir, rir_onset=onset, rir_t60=t60,
                      num_samples=np.full(rows, t), id_speech=[""] * rows)


def test_shard_wrapper_trains_and_validates_on_cpu():
    """ns_shard's ModelWrapper from the recipe with the tiny model: two
    epochs of 2 steps over a 1-batch iterator (it starts again), then the
    valid set; finite losses, trained params moved, fixed filterbanks not,
    and the schedule's warmup advanced once per step."""
    hps = copy.deepcopy(FE_T_SHARD)
    hps["model_kwargs"] = dict(TINY_KWARGS)
    hps["train"]["steps_per_epoch"] = 2
    wrapper = get_wrapper(hps["wrapper"])(HParams(**hps), train=True,
                                          device="cpu")
    assert wrapper.compute_dtype == torch.bfloat16
    wrapper.compute_dtype = None  # float32 on the CPU
    wrapper.train_step = make_train_step(wrapper.model, wrapper.loss,
                                         wrapper.optim)
    before = {p: t.detach().clone()
              for p, t in tree_paths(wrapper.state["variables"]["params"])}
    batches = [_shard_batch(5, 4, HOP * 12 + 7, 400)]
    for _ in range(2):
        summary = wrapper.train_epoch(batches)
        assert all(np.isfinite(v) for v in summary["scalars"].values())
    assert wrapper.scheduler.current_iteration == 5
    fixed = {("rf_pre", "lin", "weight"), ("rf_post", "lin", "weight")}
    for path, t in tree_paths(wrapper.state["variables"]["params"]):
        assert torch.equal(t, before[path]) == (path in fixed), path
    valid = [_batch(6, rows=2, pad_last=False)]
    scalars = wrapper.valid_epoch(valid)["scalars"]
    assert scalars.keys() == {f"loss/{k}" for k in hps["train"]["losses"]}
    assert all(np.isfinite(v) for v in scalars.values())
    # the mix: clean and noisy cut to whole hops, finite, peak <= 1
    mixed, rows = wrapper._mix_to_device(batches[0])
    assert rows == 4 and mixed["noisy"].shape == (4, HOP * 12)
    assert torch.isfinite(mixed["noisy"]).all()
    assert mixed["noisy"].abs().max() <= 1.0


def test_ns_wrapper_epoch_and_unported_options():
    """The ns wrapper's epoch (and its load/step timing); train.remat, once
    refused, trains to the same losses; the ns_on_the_fly wrapper, once
    refused, is the on-the-fly module's (tests/test_torch_ns_on_the_fly.py
    trains it), and an unknown name raises."""
    hps = copy.deepcopy(FE_T_SHARD)
    hps["model_kwargs"] = dict(TINY_KWARGS)
    hps["train"].update(fp16=False, test=True)
    wrapper = get_wrapper("ns")(HParams(**hps), train=True, device="cpu")
    summary = wrapper.train_epoch([_batch(7, pad_last=False)] * 2)
    assert all(np.isfinite(v) for v in summary["scalars"].values())
    assert wrapper.get_lr() == pytest.approx(2e-3 * 2 / 500)
    assert wrapper.timing.keys() == {"load", "step", "steps"}
    assert wrapper.timing["steps"] == 2
    hps["train"]["remat"] = True
    remat = get_wrapper("ns")(HParams(**hps), train=True, device="cpu")
    assert remat.model.remat
    got = remat.train_epoch([_batch(7, pad_last=False)] * 2)
    for k, v in summary["scalars"].items():
        assert got["scalars"][k] == pytest.approx(v, rel=1e-6), k
    otf = get_wrapper("ns_on_the_fly")
    assert otf.__module__ == "fastenhancer_tpu_torch.wrappers.ns_on_the_fly"
    with pytest.raises(ValueError, match="unknown wrapper"):
        get_wrapper("ns_unknown")


def test_remat_matches_plain_and_jax():
    """train.remat on the tiny FE with the shard recipe's losses and a
    padded row: the port's loss, every gradient and every new statistic
    with remat equal to the port's without (bit for bit: the recompute
    runs the same operations), and match JAX's train step with remat
    (jax.checkpoint), tolerances of tests/_torch_train_parity.py."""
    import _torch_train_parity as tp
    hp = _hp_train()
    jm, tm = _models()
    jv = jm.init(jax.random.PRNGKey(4))
    tv = port_variables(jv)
    batch = dict(_batch(4), row_mask=ROW_MASK)
    jm.remat = True
    (_, jmetrics, jgrads, jvars, _), = tp.run_jax_steps(jm, jv, hp, batch,
                                                        steps=1)
    loss, grads = tp.port_grads(tm, tv, hp, batch)
    tm.remat = True
    loss_r, grads_r = tp.port_grads(tm, tv, hp, batch)
    assert loss_r == loss
    assert all(torch.equal(grads_r[p], grads[p]) for p in grads)
    assert abs(loss_r / jmetrics["loss/total"] - 1) < 1e-5
    tp.assert_grads_close(grads_r, jgrads)
    stats = {}
    for remat in (True, False):
        tm.remat = remat
        stats[remat] = flatten_paths(tm.forward(
            tv, torch.from_numpy(batch["noisy"]), train=True,
            row_mask=torch.from_numpy(ROW_MASK))[2])
    assert stats[True].keys() == stats[False].keys()
    assert all(torch.equal(t, stats[False][p])
               for p, t in stats[True].items())
    assert_trees_close(tm.forward(tv, torch.from_numpy(batch["noisy"]),
                                  train=True,
                                  row_mask=torch.from_numpy(ROW_MASK))[2],
                       jvars["stats"], atol=1e-5)
