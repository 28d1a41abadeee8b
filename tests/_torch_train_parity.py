"""Shared checks of the training parity tests of every family
(tests/test_torch_train_*.py): the same seeded batch and variables through
the JAX package's train step and the port's, with the recipe's own train
section (configs/...yaml: losses including `pesq`, optimizer, groups,
schedule with a 2-step warmup).

Tolerances (float32): the train forward's spec 1e-5, wav 1e-4 and new
statistics 1e-5, as tests/test_torch_train.py; gradients leaf by leaf
within GRAD_REL (3e-3) of the leaf's largest JAX magnitude, plus 1e-7
(float32 noise of both packages, measured against float64 below). Each
optimizer step starts from one state on both sides (the second from JAX's
variables and moments after the first): losses rtol 1e-5, grad norm 1e-2,
statistics 1e-5, params 1e-5 + 5% of the learning rate (an update
normalized by Adam carries the gradients' float32 noise), except that a
param element whose two
gradients differ by more than a tenth of JAX's (its sign not fixed by
float32: a gradient zero in exact arithmetic, such as a bias that reaches
a train-mode BN through linear layers only, or one near zero), which Adam
turns into a step of either sign, is held to 3x the learning rate, and
with AdamP the rest of its leaf too (the projection mixes the leaf's
update). How many elements that widens is counted and bounded per family
(assert_steps_match), and check_optimizer_on_jax_grads holds every element
of every step, widened or not, to OPT_REL of the learning rate:
the port's optimizer from JAX's state on JAX's gradients.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from fastenhancer_tpu.losses import Losses as JLosses
from fastenhancer_tpu.models import get_model as jax_get_model
from fastenhancer_tpu.optim import get_optimizer as jget_optimizer
from fastenhancer_tpu.optim import get_scheduler as jget_scheduler
from fastenhancer_tpu.train import make_train_step as jmake_train_step
from fastenhancer_tpu_torch.losses import Losses
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.optim import get_optimizer, get_scheduler
from fastenhancer_tpu_torch.train import make_train_step
from fastenhancer_tpu_torch.utils import tree_leaves, tree_paths

from _torch_parity import (as_np, assert_trees_close, flatten_paths,
                           perturb_bn_stats, perturb_norms, port_variables,
                           to_np_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
# float32 gradients, leaf by leaf, of the largest magnitude: against a
# float64 run of the port, JAX's are off by up to 1.7e-3 and the port's by
# up to 5.5e-4 (BSRNN, LiSenNet, ln, dpt at these widths)
GRAD_REL = 3e-3
# the grad norm of a step: at JAX's state after the first step JAX's
# float32 norm is 0.56% from float64's, the port's 0.13% (dpt at these
# widths; the consistency loss's |X|^0.3 is steep at small bins)
GNORM_RTOL = 1e-2


def recipe_hp(config, model_kwargs):
    """The train section of configs/<config>, with the consistency loss at
    the model's STFT (as both wrappers fill it in) and a 2-step warmup, so
    both steps run at a learning rate of 1/500 and 2/500 of the recipe's."""
    with open(os.path.join(REPO, "configs", config)) as f:
        hp = yaml.safe_load(f)["train"]
    if "consistency" in hp["losses"]:
        hp["losses"]["consistency"].update(
            n_fft=model_kwargs.get("n_fft", 512),
            hop_size=model_kwargs.get("hop_size", 256),
            win_size=model_kwargs.get("win_size"),
            win_type=model_kwargs.get("window"))
    hp["scheduler_kwargs"]["warmup_iterations"] = 2
    return hp


def make_batch(seed, rows, samples, silent_edges=0):
    """{clean, noisy, row_mask} numpy; the last row is zeros and masked
    out, as a row padded to fill a batch; the first and last
    `silent_edges` samples of every row are silent (LiSenNet's phase
    features sit on their branch cut on the offline STFT's edge frames of
    other audio, where reflect padding makes the spectrum real)."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((rows, samples)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal(clean.shape) * 0.05).astype(
        np.float32)
    if silent_edges:
        for x in (clean, noisy):
            x[:, :silent_edges] = x[:, -silent_edges:] = 0.0
    clean[-1] = noisy[-1] = 0.0
    mask = np.ones(rows, np.float32)
    mask[-1] = 0.0
    return {"clean": clean, "noisy": noisy, "row_mask": mask}


def check_train_forward(jm, jv, tm, tv, batch, spec_atol=1e-5):
    """forward(train=True, row_mask=...) against JAX: outputs and every new
    statistic, and no statistic moved by the padded row."""
    noisy, mask = batch["noisy"], batch["row_mask"]
    wj, sj, stj = jax.jit(functools.partial(jm.forward, train=True))(
        jv, jnp.asarray(noisy), row_mask=jnp.asarray(mask))
    wt, st, stt = tm.forward(tv, torch.from_numpy(noisy), train=True,
                             row_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(as_np(st), np.asarray(sj), atol=spec_atol)
    np.testing.assert_allclose(as_np(wt), np.asarray(wj), atol=1e-4)
    assert_trees_close(stt, stj, atol=1e-5)
    real = mask > 0
    _, _, alone = tm.forward(tv, torch.from_numpy(noisy[real]), train=True)
    assert_trees_close(alone, stj, atol=1e-5)
    assert all(torch.isfinite(t).all() for t in tree_leaves(stt))


def port_grads(tm, tv, hp, batch):
    """(total loss, {path: gradient}) of the recipe's weighted loss as the
    port's train step takes it (train forward, float32 losses, row mask)."""
    los = Losses(hp["losses"])
    params = tv["params"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        clean = torch.from_numpy(batch["clean"])
        noisy = torch.from_numpy(batch["noisy"])
        mask = torch.from_numpy(batch["row_mask"])
        wav_hat, spec_hat, _ = tm.forward(tv, noisy, train=True,
                                          row_mask=mask)
        total, _ = los.calculate(wav_hat.float(), spec_hat.float(), clean,
                                 tm.stft(clean), row_mask=mask)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = {path: torch.zeros_like(p) if g is None else g
             for (path, p), g in zip(tree_paths(params), grads)}
    return float(total.detach()), grads


def assert_grads_close(tgrads, jgrads):
    """Every leaf's gradient within GRAD_REL of its largest JAX
    magnitude."""
    j = flatten_paths(to_np_tree(jgrads))
    assert set(j) == set(tgrads), sorted(set(j) ^ set(tgrads))
    for path, g in tgrads.items():
        want = np.asarray(j[path], np.float32)
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(as_np(g), want, rtol=0,
                                   atol=GRAD_REL * scale + 1e-7,
                                   err_msg=str(path))


def run_jax_steps(jm, jv, hp, batch, steps=STEPS):
    """The JAX package's jitted train step `steps` times on one batch ->
    [(lrs, metrics, grads, variables, optimizer state)], numpy leaves."""
    jo = jget_optimizer(jm, jv["params"], hp)
    sched = jget_scheduler(jo, hp)
    step = jmake_train_step(jm, JLosses(hp["losses"]), jo, donate=False,
                            return_grads=True)
    state = {"variables": jv, "opt_state": jo.init(jv["params"])}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        lrs = list(sched.lrs)
        state, m = step(state, jbatch, jnp.asarray(lrs, jnp.float32))
        sched.warmup_step()
        grads = m.pop("grads")
        out.append((lrs, {k: float(v) for k, v in m.items()}, grads,
                    to_np_tree(state["variables"]),
                    to_np_tree(state["opt_state"])))
    return out


def run_port_steps(tm, tv, hp, batch, compute_dtype=None, steps=STEPS,
                   resync=None):
    """The port's train step `steps` times on one batch, on a copy of the
    variables (the optimizer updates its leaves in place) -> [(lrs,
    metrics, the gradients each step took (port_grads before it, float32
    runs only), a copy of the variables after it)]. With `resync` (the
    JAX steps of run_jax_steps) each step after the first starts from
    JAX's variables and optimizer state after the one before, so every
    step is compared from one state."""
    tv = _clone(tv)
    to = get_optimizer(tm, tv["params"], hp)
    sched = get_scheduler(to, hp)
    step = make_train_step(tm, Losses(hp["losses"]), to,
                           compute_dtype=compute_dtype)
    state = {"variables": tv}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for i in range(steps):
        if resync is not None and i:
            _, _, _, jvars, jopt = resync[i - 1]
            with torch.no_grad():
                for part in ("params", "stats"):
                    saved = flatten_paths(jvars[part])
                    for path, t in tree_paths(state["variables"][part]):
                        t.copy_(torch.from_numpy(np.array(saved[path])))
            to.load_state_tree(jopt)
        lrs = list(sched.lrs)
        grads = (None if compute_dtype is not None else
                 port_grads(tm, state["variables"], hp, batch)[1])
        state, m = step(state, tbatch, lrs)
        sched.warmup_step()
        out.append((lrs, {k: float(v) for k, v in m.items()}, grads,
                    _clone(state["variables"])))
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def assert_steps_match(tsteps, jsteps, projected):
    """Each step's losses, grad norm, params and statistics (tolerances in
    the module docstring), the port's steps run with resync=jsteps;
    `projected`: the optimizer is AdamP. Returns (param elements held to
    the wide bound, param elements compared), summed over the steps."""
    wide = total = 0
    for i, ((tl, tm_, tg, tv), (jl, jm_, jg, jv, _)) in enumerate(
            zip(tsteps, jsteps)):
        assert tl == jl, (tl, jl)
        assert tm_.keys() == jm_.keys()
        for k in jm_:
            np.testing.assert_allclose(
                tm_[k], jm_[k], rtol=GNORM_RTOL if k == "grad_norm"
                else 1e-5, err_msg=f"{k} step {i}")
        grads = flatten_paths(to_np_tree(jg))
        jparams = flatten_paths(jv["params"])
        for path, leaf in tree_paths(tv["params"]):
            g = np.asarray(grads[path])
            signless = np.abs(as_np(tg[path]) - g) > 0.1 * np.abs(g)
            if projected and signless.any():
                signless[...] = True  # AdamP's projection mixes the leaf
            wide += int(signless.sum())
            total += signless.size
            np.testing.assert_array_less(
                np.abs(as_np(leaf) - jparams[path]),
                1e-5 + max(jl) * (0.05 + 3 * signless),
                err_msg=f"{path} step {i}")
        assert_trees_close(tv["stats"], jv["stats"], atol=1e-5)
    return wide, total


# the port's optimizer on JAX's gradients from JAX's state, against JAX's
# params after the step, relative to the step's largest learning rate
OPT_REL = 1e-3


def check_optimizer_on_jax_grads(case):
    """Each step of case["jax_steps"] again through the port's optimizer
    alone, from the state JAX started it at (step 0: the case's variables
    and a fresh optimizer; then JAX's variables and optimizer state after
    the step before) with JAX's gradients of that step: every param
    element within 1e-6 + OPT_REL x the learning rate of JAX's. This holds
    the elements that assert_steps_match widens (a gradient whose float32
    sign is free, and with AdamP the rest of its leaf) to the optimizer's
    math: the AdamP projection, the weight decay and the group of each
    leaf. Returns the largest gap over the learning rate (1.2e-4 for every
    family at these widths)."""
    tv = _clone(case["tv"])
    to = get_optimizer(case["tm"], tv["params"], case["hp"])
    worst = 0.0
    for i, (lrs, _, jg, jvars, _) in enumerate(case["jax_steps"]):
        if i:
            _, _, _, prev, jopt = case["jax_steps"][i - 1]
            saved = flatten_paths(prev["params"])
            with torch.no_grad():
                for path, t in tree_paths(tv["params"]):
                    t.copy_(torch.from_numpy(np.array(saved[path])))
            to.load_state_tree(jopt)
        grads = flatten_paths(to_np_tree(jg))
        for path, t in tree_paths(tv["params"]):
            t.grad = torch.from_numpy(np.array(grads[path], np.float32))
        to.set_lrs(lrs)
        to.step()
        to.zero_grad(set_to_none=True)
        want = flatten_paths(jvars["params"])
        for path, t in tree_paths(tv["params"]):
            gap = np.abs(as_np(t) - want[path])
            np.testing.assert_array_less(gap, OPT_REL * max(lrs),
                                         err_msg=f"{path} step {i}")
            worst = max(worst, float(gap.max(initial=0.0)) / max(lrs))
    return worst


def check_names_and_groups(case):
    """The port's reference torch names of every param path, its fixed
    (untrained) paths, and the recipe's optimizer groups equal JAX's: the
    same leaf -> group map and group kwargs (a name that no group regex
    matches would put its leaf in the default group unseen: a weight decay
    of lr x wd x p moves a param ~1e-8 in the two-step tests, far under
    their bounds). Returns the number of leaves per group."""
    jm, tm, hp = case["jm"], case["tm"], case["hp"]
    tv = _clone(case["tv"])
    for path, _ in tree_paths(tv["params"]):
        assert tm.torch_name(path) == jm.torch_name(path), path
    as_set = lambda paths: {tuple(map(str, p)) for p in paths}
    assert as_set(tm.fixed_param_paths()) == as_set(jm.fixed_param_paths())
    jo = jget_optimizer(jm, case["jv"]["params"], hp)
    to = get_optimizer(tm, tv["params"], hp)
    assert to.n_groups == jo.n_groups
    assert to.base_lrs == jo.base_lrs
    leaves = {id(t): path for path, t in tree_paths(tv["params"])}
    got = {leaves[id(p)]: gid for gid, g in enumerate(to.param_groups)
           for p in g["params"]}
    assert got == jo.assignment
    assert [g["hparams"] for g in to.param_groups] == jo.group_kwargs
    return np.bincount(list(got.values()), minlength=to.n_groups).tolist()


def build_case(model, kwargs, config, frames=12, norms=False,
               silent_edges=0):
    """Both models, seeded variables (BN statistics and affines drawn away
    from their init; with `norms` the ln ablation's GroupNorm/LayerNorm
    affines too), the recipe's train section and a 3-row batch of
    `frames` hops whose last row is padding. The variables come from the
    port's init, moved to JAX by path (the inits themselves are held to
    JAX's by the per-family test files; JAX's init of BSRNN's 31 bands
    alone takes ~40 s here)."""
    jm, tm = jax_get_model(model, **kwargs), get_model(model, **kwargs)
    init = to_np_tree(tm.init(torch.Generator().manual_seed(0), "cpu"))
    init = perturb_bn_stats(init, 0)
    if norms:
        init["params"] = perturb_norms(init["params"], 0)
    jv = jax.tree.map(jnp.asarray, init)
    hop = kwargs.get("hop_size", 256)
    return {"jm": jm, "tm": tm, "jv": jv, "tv": port_variables(jv),
            "hp": recipe_hp(config, kwargs),
            "batch": make_batch(1, 3, hop * frames,
                                silent_edges=silent_edges)}


def check_no_kernel_in_train(case, monkeypatch, has_gru):
    """A float32 train step calls #5's plain version (`gru_scan_reference`,
    what every GRU-scan wrapper runs on a CPU tensor) no time: no kernel
    is launched inside a train step; the eval forward does, where the
    family has a GRU (the spy works)."""
    calls = []
    real = scan.gru_scan_reference
    monkeypatch.setattr(scan, "gru_scan_reference",
                        lambda *a: calls.append(1) or real(*a))
    tm, tv = case["tm"], case["tv"]
    run_port_steps(tm, tv, case["hp"], case["batch"], steps=1)
    assert not calls
    with torch.no_grad():
        tm.forward(tv, torch.from_numpy(case["batch"]["noisy"]))
    assert bool(calls) == has_gru


BF16_REL = 2 ** -5


def check_bf16_step(case):
    """One bfloat16 step of the port (params and wavs cast for the forward
    and backward over float32 masters) against JAX's float32 step from the
    same state: every loss within BF16_REL relative. Control: the same
    losses miss 1e-4, which the port's float32 step meets (to 1e-5), so
    the step did run in bfloat16.

    Why not JAX's bf16 step: the two round to bfloat16 at different points
    (torch's CPU convolutions and products keep float32 sums where XLA's
    round; the port's eval GRU keeps a float32 state), and at these widths
    the port's bf16 losses differ from JAX's bf16 ones by as much as
    either differs from float32 (5.8e-3 against 4.2e-3 on the default
    model; 7.3e-3 against 2.0e-2 on dpt, seeds 0-1), so no bound told
    a bf16 step from a float32 one there."""
    steps = run_port_steps(case["tm"], case["tv"], case["hp"],
                           case["batch"], compute_dtype=torch.bfloat16,
                           steps=1)
    got, want = steps[0][1], case["jax_steps"][0][1]
    rel = {k: abs(got[k] / want[k] - 1) for k in want
           if k.startswith("loss/")}
    assert max(rel.values()) <= BF16_REL, rel
    assert max(rel.values()) > 1e-4, rel
    assert np.isfinite(got["grad_norm"])
