"""The exported runner's tick (fastenhancer_tpu_torch/scripts/run_exported.py)
on the CPU, at tests/test_torch_export.py's tiny sizes.

The program's own forward flattens (variables, carry, feed) against its
input spec at every call, in Python (torch.fx's `tree_flatten_spec`, one
call a node of the input tree). The runner checks the first tick through
that forward and runs the later ticks on the graph's flat inputs, the
variables flattened once: a steady tick flattens only the carry. Its
outputs and carries stay bit-equal to the program's own forward.
"""
import functools

import numpy as np
import pytest
import torch
from torch.fx import _pytree as fx_pytree

from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.scripts import export, run_exported

from _torch_parity import real_triton_only, torch_one_thread  # noqa: F401
from test_torch_export import B, FAMILIES

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

TICKS = 6
# (family, spec2spec): each exported --fused, as the runner's artifacts are
# (dpt's op writes its K/V caches in place)
FORMS = [("bsrnn", False), ("dpt", False), ("fe", False), ("fe", True)]


@functools.lru_cache(maxsize=None)
def _program(fam, spec2spec):
    """(the loaded program's module, variables, zero carry, feed shape) of
    FAMILIES[fam] exported fused at B streams, on the CPU; exported once a
    form in this file (each caller clones the carry it steps)."""
    name, kw = FAMILIES[fam]
    model = get_model(name, **kw)
    cpu = torch.device("cpu")
    folded = model.fold(model.init(torch.Generator().manual_seed(5),
                                   device=cpu))
    step, carry0, feed = export.make_step(model, folded, B, cpu, spec2spec,
                                          fused=True)
    program = torch.export.export(export.StepModule(step),
                                  (folded, carry0, feed))
    return program.module(), folded, carry0, tuple(feed.shape)


def _nodes(tree):
    """tree_flatten_spec's calls on `tree`: one a node."""
    leaves, spec = torch.utils._pytree.tree_flatten(tree)
    del leaves
    return spec.num_nodes


@pytest.mark.parametrize("fam,spec2spec", FORMS, ids=[
    f"{f}-{'s2s' if s else 'w2w'}" for f, s in FORMS])
def test_steady_tick_flattens_only_the_carry(fam, spec2spec, monkeypatch):
    step, variables, carry0, shape = _program(fam, spec2spec)
    rng = np.random.default_rng(3)
    feeds = (rng.standard_normal((TICKS,) + shape) * 0.3).astype(np.float32)

    calls = []
    flatten = fx_pytree.tree_flatten_spec

    def counted(*args, **kwargs):
        calls[-1] += 1
        return flatten(*args, **kwargs)

    call = run_exported.make_call(step, variables, torch.device("cpu"))
    got, want = [], []
    carry, ref = export.clone_tree(carry0), export.clone_tree(carry0)
    with torch.no_grad():
        for x in feeds:
            with monkeypatch.context() as m:
                m.setattr(fx_pytree, "tree_flatten_spec", counted)
                calls.append(0)
                carry, y = call(carry, x)
            got.append((carry, y))
            ref, y_ref = step(variables, ref, torch.from_numpy(x))
            want.append((ref, y_ref))
    # the first tick runs the program's own forward: every node of its
    # inputs; each later tick only the carry's
    inputs = ([variables, carry0, torch.zeros(shape)], {})
    assert calls[0] >= _nodes(inputs)
    assert calls[1:] == [_nodes(carry0)] * (TICKS - 1), calls
    for (c, y), (cr, yr) in zip(got, want):
        torch.testing.assert_close(y, yr, rtol=0, atol=0)
        for a, b in zip(torch.utils._pytree.tree_leaves(c),
                        torch.utils._pytree.tree_leaves(cr)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_first_tick_checks_the_inputs():
    step, variables, carry0, shape = _program("bsrnn", False)
    call = run_exported.make_call(step, variables, torch.device("cpu"))
    wrong = np.zeros((shape[0], shape[1] + 1), np.float32)
    with torch.no_grad(), pytest.raises(Exception):
        call(export.clone_tree(carry0), wrong)


def test_pre_uploaded_feed_takes_the_same_path():
    step, variables, carry0, shape = _program("bsrnn", False)
    rng = np.random.default_rng(4)
    feeds = (rng.standard_normal((3,) + shape) * 0.3).astype(np.float32)
    host = run_exported.make_call(step, variables, torch.device("cpu"))
    tensor = run_exported.make_call(step, variables, torch.device("cpu"))
    c1, c2 = export.clone_tree(carry0), export.clone_tree(carry0)
    with torch.no_grad():
        for x in feeds:
            c1, y1 = host(c1, x)
            c2, y2 = tensor(c2, torch.from_numpy(x))
            torch.testing.assert_close(y1, y2, rtol=0, atol=0)
