"""optim/ against fastenhancer_tpu/optim/: the AdamP/AdamW/Adam updates
over 5 steps, the regex group partition of the shard recipe and of FE_B,
the schedulers, and the reference parameter names.

Tolerance: float32 rtol 1e-5, atol 1e-7 on params after each step.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu import optim as jopt
from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu_torch import optim as topt
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.presets import FE_B, FE_T_SHARD
from fastenhancer_tpu_torch.utils import tree_paths

from _torch_parity import (TINY_KWARGS, flatten_paths, port_variables,
                           real_triton_only, torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

SHAPES = {"w2": (8, 5), "w3": (4, 3, 2), "b": (6,), "s": (1,)}


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name,kwargs", [
    ("AdamP", {"projection": "auto"}),
    ("AdamP", {"projection": "auto", "delta": 1.0, "nesterov": True}),
    ("AdamP", {"projection": "disabled"}),
    ("AdamP", {"projection": "channelwise"}),
    ("AdamP", {"projection": "layerwise"}),
    ("AdamP", {"projection": "1"}),
    ("AdamP", {"projection": 0}),
    ("AdamW", {}),
    ("Adam", {"weight_decay": 0.05}),
], ids=["auto", "auto-delta1-nesterov", "disabled", "channelwise",
        "layerwise", "dim1", "dim0", "adamw", "adam"])
def test_update_matches_jax_over_5_steps(name, kwargs):
    kw = {**dict(lr=1e-2, betas=[0.9, 0.99], weight_decay=0.01,
                 wd_ratio=0.5), **kwargs}
    p0 = _params(0)
    assign = {(k,): 0 for k in p0}
    jo = jopt.GroupedOptimizer(name, p0, assign, [kw])
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jo.init(jp)
    tp_ = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    to = topt.GroupedOptimizer(name, tp_, assign, [kw])
    rng = np.random.default_rng(1)
    for step in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in SHAPES.items()}
        # a gradient along the weight (radial) on w2 at step 2, so that
        # "auto" projects there
        if step == 2:
            grads["w2"] = p0["w2"] * 3.0
        lr = 1e-2 * (step + 1)
        jp, js = jo.update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                           js, jnp.asarray([lr], jnp.float32))
        for k, p in tp_.items():
            p.grad = torch.from_numpy(grads[k])
        to.set_lrs([lr])
        to.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp_[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} step {step}")


def test_auto_projects_a_tangent_step_channelwise():
    """A first step whose sign pattern is orthogonal to every row of the
    weight: "auto" takes the channelwise projection, as JAX does. The step
    is tangent already, so the projection shows in the decay alone:
    wd_ratio 0.5 instead of 1, lr * wd * 0.5 * |w| = 2e-4 at the last row."""
    p0 = {"w": np.tile(np.array([1.0, 1.0, 0.0, 0.0, 0.0], np.float32),
                       (4, 1)) * np.arange(1, 5, dtype=np.float32)[:, None]}
    g = np.tile(np.array([1.0, -1.0, 0.3, -0.2, 0.1], np.float32), (4, 1))
    out = {}
    for proj in ("auto", "disabled"):
        kw = dict(lr=1e-2, weight_decay=0.01, wd_ratio=0.5, projection=proj)
        jo = jopt.GroupedOptimizer("AdamP", p0, {("w",): 0}, [kw])
        jp = {"w": jnp.asarray(p0["w"])}
        jp, _ = jo.update(jp, {"w": jnp.asarray(g)}, jo.init(jp),
                          jnp.asarray([1e-2], jnp.float32))
        tp_ = {"w": torch.from_numpy(p0["w"].copy())}
        to = topt.GroupedOptimizer("AdamP", tp_, {("w",): 0}, [kw])
        tp_["w"].grad = torch.from_numpy(g)
        to.step()
        np.testing.assert_allclose(tp_["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-7)
        out[proj] = tp_["w"].numpy()
    np.testing.assert_allclose(np.abs(out["auto"] - out["disabled"]).max(),
                               2e-4, atol=1e-6)  # ulp(4.0) = 4.8e-7


@pytest.mark.parametrize("hp_name", ["FE_T_SHARD", "FE_B"])
def test_group_partition_matches_jax(hp_name):
    """The shard recipe's four regex groups on FE-T's names, and the same
    groups on FE_B: the same leaf -> group map and group kwargs as JAX
    (the regexes match the default model's names only in part; both keep
    that as it is)."""
    hp = FE_T_SHARD["train"]
    kwargs = FE_T_SHARD["model_kwargs"] if hp_name == "FE_T_SHARD" else FE_B
    jm, tm = JModel(**kwargs), TModel(**kwargs)
    jv = jm.init(jax.random.PRNGKey(0))
    tv = port_variables(jv)
    jo = jopt.get_optimizer(jm, jv["params"], hp)
    to = topt.get_optimizer(tm, tv["params"], hp)
    assert to.n_groups == jo.n_groups == 16
    assert to.base_lrs == jo.base_lrs
    leaves = dict((id(t), path) for path, t in tree_paths(tv["params"]))
    got = {leaves[id(p)]: gid for gid, g in enumerate(to.param_groups)
           for p in g["params"]}
    assert got == jo.assignment
    assert [g["hparams"] for g in to.param_groups] == jo.group_kwargs
    if hp_name == "FE_T_SHARD":
        counts = np.bincount(list(got.values()), minlength=16)
        assert counts[0] == 57 and counts[4] == 5 and counts.sum() == 62


def test_schedulers_match_jax():
    """600 iterations of CosineAnnealingWarmup (100 a epoch, warmup 500),
    and the other schedulers over a few epochs."""
    base = [2e-3, 1e-3]
    j = jopt.CosineAnnealingWarmup(base, warmup_iterations=500, T_max=200,
                                   eta_min=1e-6)
    t = topt.CosineAnnealingWarmup(base, warmup_iterations=500, T_max=200,
                                   eta_min=1e-6)
    for it in range(1, 601):
        assert t.lrs == j.lrs, it
        j.warmup_step()
        t.warmup_step()
        if it % 100 == 0:
            j.step()
            t.step()
    assert t.lrs == j.lrs and t.T_max == j.T_max == 196
    for cls, kw, metrics in (
            ("CosineAnnealingLR", dict(T_max=10), [None] * 5),
            ("CosineAnnealingWarmupRestarts",
             dict(first_cycle_steps=4, max_lr=1e-2, warmup_steps=1),
             [None] * 9),
            ("ReduceLROnPlateau", dict(patience=1, initial_patience=1),
             [1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5])):
        j = getattr(jopt, cls)(base, **kw)
        t = getattr(topt, cls)(base, **kw)
        for m in metrics:
            j.step(m)
            t.step(m)
            assert t.lrs == j.lrs, cls


def test_torch_names_and_num_params():
    """Every param path maps to the JAX package's reference name, and the
    shard recipe's FE-T counts 22,451 trainable parameters."""
    for kwargs in (FE_T_SHARD["model_kwargs"], TINY_KWARGS):
        jm, tm = JModel(**kwargs), TModel(**kwargs)
        jv = jm.init(jax.random.PRNGKey(0))
        tv = port_variables(jv)
        paths = [p for p, _ in tree_paths(tv["params"])]
        assert set(paths) == set(flatten_paths(
            jax.tree.map(np.asarray, jv["params"])))
        for path in paths:
            assert tm.torch_name(path) == jm.torch_name(path), path
        assert tm.fixed_param_paths() == jm.fixed_param_paths()
        assert tm.num_params(tv["params"]) == jm.num_params(jv["params"])
    m = TModel(**FE_T_SHARD["model_kwargs"])
    v = m.init(torch.Generator().manual_seed(0), "cpu")
    assert m.num_params(v["params"]) == 22_451


def test_scheduler_factory_and_bad_names():
    hp = copy.deepcopy(FE_T_SHARD["train"])
    tm = TModel(**TINY_KWARGS)
    tv = tm.init(torch.Generator().manual_seed(0), "cpu")
    opt = topt.get_optimizer(tm, tv["params"], hp)
    sched = topt.get_scheduler(opt, hp)
    assert isinstance(sched, topt.CosineAnnealingWarmup)
    assert sched.T_max == 200 and sched.lrs == [2e-3 / 500] * 16
    with pytest.raises(ValueError, match="optimizer"):
        topt.GroupedOptimizer("SGD", tv["params"], {}, [{}])
    with pytest.raises(ValueError, match="scheduler"):
        topt.get_scheduler(opt, dict(hp, scheduler="StepLR"))
