"""The seven kernels as `torch.library` ops (fastenhancer_tpu_torch/ops/
_library.py), on the CPU at tiny shapes: each op's schema (the dpt stack
declares its K/V caches mutated, and mutates nothing else) and its fake
implementation through `torch.library.opcheck`, the fake outputs' shapes,
types and devices against the CPU outputs', each wrapper's route through
its op, the launch counters left alone on the CPU, and the GRU scan's
gradient through its op against the plain version's.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from fastenhancer_tpu_torch.models.fastenhancer.default import Model
from fastenhancer_tpu_torch.ops import (_build, _library, bsrnn_stack,
                                        dprnn_stack, dpt_stack, fused_frame,
                                        rnnformer_stack)
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.ops import segmental_rms as seg

from _torch_parity import (TINY_KWARGS, real_triton_only,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

B, HEADS = 2, 2


def _rand(rng, shape, scale=0.3):
    return torch.from_numpy((rng.standard_normal(shape) * scale
                             ).astype(np.float32))


def _plan(rng, shapes):
    return {k: _rand(rng, s, 0.2) for k, s in shapes.items()}


def _case(name):
    """-> (the op's arguments, the wrapper's call on the same operands,
    the wrapper and its counter attributes)."""
    rng = np.random.default_rng(CASES.index(name))
    if name.startswith("rnnformer_stack"):
        ln = name.endswith("ln")
        nb, f, c = 2, 4, 8
        plan = _plan(rng, rnnformer_stack.plan_shapes(nb, f, c, ln))
        if ln:
            plan["ln_eps"] = 1e-5
        x, h = _rand(rng, (B, f, c)), _rand(rng, (nb, B * f, c))
        return ((rnnformer_stack.plan_tensors(plan), x, h, HEADS,
                 plan.get("ln_eps")),
                lambda: rnnformer_stack.rnnformer_stack_step(plan, x, h,
                                                             HEADS),
                rnnformer_stack.rnnformer_stack_step,
                ("launches", "ln_launches"))
    if name == "fused_frame":
        # the whole frame's envelope: kernel_size[0] == 2 * stride, SiLU
        model = Model(**dict(TINY_KWARGS, kernel_size=[8, 3],
                             activation="SiLU"))
        folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                       "cpu"))
        plan = model.build_frame_plan(folded)
        enc_ks = tuple(model.kernel_size[1:])
        kw = dict(num_blocks=model.num_blocks, num_heads=model.rf.num_heads,
                  n_enc=len(enc_ks), enc_ks=enc_ks, f_enc=model.freq,
                  block_freq=model.block_freq, stride=model.stride,
                  resnet=model.resnet, mask=model.mask_name)
        x = _rand(rng, (B, model.freq + 1, 2 * model.stride))
        h = _rand(rng, (model.num_blocks, B * model.block_freq,
                        model.block_channels))
        return (([plan[k] for k in fused_frame.frame_plan_keys(len(enc_ks))],
                 [plan["stack"][k] for k in fused_frame.STACK_KEYS], x, h,
                 kw["num_heads"], list(enc_ks), kw["f_enc"],
                 kw["block_freq"], kw["stride"], kw["resnet"], kw["mask"]),
                lambda: fused_frame.fused_frame_step(plan, x, h, **kw),
                fused_frame.fused_frame_step, ("launches",))
    if name == "dpt_stack":
        nb, f, c, lb = 2, 4, 8, 3
        plan = _plan(rng, dpt_stack.plan_shapes(nb, f, c, HEADS, lb))
        x = _rand(rng, (B, f, c))
        kc, vc = (_rand(rng, dpt_stack.cache_shape(nb, B, lb, f, c))
                  for _ in range(2))
        ptr = torch.tensor(1, dtype=torch.int32)
        return (([plan[k] for k in dpt_stack.PLAN_KEYS], x, kc, vc, ptr,
                 HEADS),
                lambda: dpt_stack.dpt_stack_step(plan, x, kc.clone(),
                                                 vc.clone(), ptr, HEADS),
                dpt_stack.dpt_stack_step, ("launches", "tc_launches"))
    if name == "bsrnn_stack":
        nl, f, c, hd = 2, 3, 8, 8
        plan = _plan(rng, bsrnn_stack.plan_shapes(nl, c, hd))
        x, h = _rand(rng, (f, B, c)), _rand(rng, (nl, 2, f, B, hd))
        return (([plan[k] for k in bsrnn_stack.PLAN_KEYS], x, h),
                lambda: bsrnn_stack.bsrnn_stack_step(plan, x, h),
                bsrnn_stack.bsrnn_stack_step, ("launches", "tc_launches"))
    if name == "dprnn_stack":
        nb, f, c, hd = 2, 3, 8, 4
        plan = _plan(rng, dprnn_stack.plan_shapes(nb, c, hd))
        x, h = _rand(rng, (f, B, c)), _rand(rng, (nb, f, B, c))
        return (([plan[k] for k in dprnn_stack.PLAN_KEYS], x, h),
                lambda: dprnn_stack.dprnn_stack_step(plan, x, h),
                dprnn_stack.dprnn_stack_step, ("launches", "tc_launches"))
    if name == "gru_scan":
        t, n, hd = 3, 4, 5
        args = (_rand(rng, (t, n, 3 * hd)), _rand(rng, (n, hd)),
                _rand(rng, (3 * hd, hd)), _rand(rng, (3 * hd,)))
        return (args, lambda: scan.gru_scan(*args), scan.gru_scan,
                ("launches", "tc_launches"))
    if name.startswith("segmental_rms"):
        floor = None if name.endswith("floor") else -50.0
        wav = _rand(rng, (B, 3 * 1600 + 7))
        wav[0, :1600] *= 1e-3  # one quiet frame
        return ((wav, 16_000, 100, -25.0, floor),
                lambda: seg.segmental_rms_fused(
                    wav, absolute_threshold_db=floor),
                seg.segmental_rms_fused, ("launches",))
    raise KeyError(name)


CASES = ["rnnformer_stack", "rnnformer_stack-ln", "fused_frame", "dpt_stack",
         "bsrnn_stack", "dprnn_stack", "gru_scan", "segmental_rms",
         "segmental_rms-no-floor"]


def _op(name):
    return getattr(torch.ops.fastenhancer, name.split("-")[0]).default


def test_every_kernel_is_an_op():
    """One op a kernel source, each with a CPU, a CUDA and a fake
    implementation."""
    assert set(_library.OPS) == set(_build.SOURCES)
    for name in _library.OPS:
        op = getattr(torch.ops.fastenhancer, name).default
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                op.name(), key), (name, key)


@pytest.mark.parametrize("name", CASES)
def test_opcheck_and_fake_shapes(name):
    args, _, _, _ = _case(name)
    result = torch.library.opcheck(
        _op(name), args, test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}, result
    mode = FakeTensorMode()
    fake_args = pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
    with mode:
        fake = _op(name)(*fake_args)
    real = _op(name)(*pytree.tree_map_only(torch.Tensor, torch.clone, args))
    fake, real = pytree.tree_leaves(fake), pytree.tree_leaves(real)
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)


def test_dpt_schema_mutates_only_the_caches():
    schema = torch.ops.fastenhancer.dpt_stack.default._schema
    written = [a.name for a in schema.arguments
               if a.alias_info is not None and a.alias_info.is_write]
    assert written == ["kc", "vc"]


class _Ops(TorchDispatchMode):
    """Records every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", CASES)
def test_wrapper_calls_its_op_once(name):
    """The wrapper reaches its op once, gives the op's outputs, and counts
    no launch on the CPU (the counters sit in the CUDA implementation)."""
    args, wrapper_call, wrapper, counters = _case(name)
    before = {a: getattr(wrapper, a) for a in counters}
    with _Ops() as rec:
        got = wrapper_call()
    mine = [f for f in rec.seen if f.namespace == "fastenhancer"]
    assert mine == [_op(name)]
    want = _op(name)(*pytree.tree_map_only(torch.Tensor, torch.clone, args))
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(g.reshape(w.shape), w, rtol=0, atol=0)
    assert {a: getattr(wrapper, a) for a in counters} == before


def test_gru_scan_gradient_through_the_op():
    """The op's backward (the plain version run again under autograd)
    gives the plain version's gradients, for every input."""
    args, _, _, _ = _case("gru_scan")
    g = np.random.default_rng(9)
    w_ys, w_h = _rand(g, (3, 4, 5)), _rand(g, (4, 5))
    grads = []
    for fn in (scan.gru_scan, scan.gru_scan_reference):
        leaves = [a.clone().requires_grad_() for a in args]
        ys, h_t = fn(*leaves)
        ((ys * w_ys).sum() + (h_t * w_h).sum()).backward()
        grads.append([a.grad for a in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
