"""The dprnn stack wrapper's choice of kernel form, its tensor-core form's
shared memory and its argument checks, on the CPU (no JAX, no card).

The kernel's arithmetic against the JAX package is in test_torch_dprnn.py;
both forms against the plain version on the card are in
test_torch_cuda_kernels.py.
"""
import pytest
import torch

from fastenhancer_tpu_torch.ops import dprnn_stack as dprnn

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

BF16 = torch.bfloat16
# the H100's shared memory a SM (228 KB), and what it reserves a block
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024


@pytest.mark.parametrize("name,f,c,hd", [("DPRNN-T", 16, 20, 10),
                                         ("DPRNN-B", 24, 36, 18),
                                         ("DPRNN-S", 36, 48, 24)])
def test_dprnn_configs_run_the_tc_form_in_bf16(name, f, c, hd):
    assert dprnn.kernel_form(f, c, hd, BF16) == "tc", name
    assert dprnn.kernel_form(f, c, hd, torch.float32) == "scalar", name


@pytest.mark.parametrize("f,c,hd", [
    (48, 72, 36),    # DPRNN-M: Hd > 32, one lane a unit no longer covers it
    (64, 96, 48),    # DPRNN-L
    (24, 36, 33),
    (900, 36, 18)])  # the tiles outgrow shared memory
def test_other_shapes_run_the_scalar_form(f, c, hd):
    assert dprnn.kernel_form(f, c, hd, BF16) == "scalar"
    assert dprnn.kernel_form(f, c, hd, torch.float32) == "scalar"


@pytest.mark.parametrize("f,c,hd,want", [
    # zero chunk + x, h, h' tiles, xp [F, 2, 3Hd], ys [F, ld(2Hd)]; two
    # slots, each the GRU stage's six [C, C] weights and four biases in
    # padded rows
    (24, 36, 18, 2 * (16 + (3 * 24 * 40 + 24 * 108 + 24 * 40)
                      + 2 * (6 * 36 * 40 + 4 * 40))),
    (16, 20, 10, 2 * (16 + (3 * 16 * 24 + 16 * 60 + 16 * 24)
                      + 2 * (6 * 20 * 24 + 4 * 24))),
    # at C = 12, Hd = 32 the sweep's stage (W_fih, W_fhh, biases) is the
    # largest: 2C + 2Hd rows of ld(96) = 104
    (5, 12, 32, 2 * (16 + (3 * 5 * 24 + 5 * 192 + 5 * 72)
                     + 2 * (24 * 104 + 64 * 104 + 2 * 192)))])
def test_tc_smem_bytes(f, c, hd, want):
    assert dprnn.tc_smem_bytes(f, c, hd) == want
    assert want <= dprnn.MAX_SMEM_BYTES


def test_dprnn_b_tc_form_runs_two_blocks_a_sm():
    smem = dprnn.tc_smem_bytes(24, 36, 18)
    assert 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


def test_tc_shared_memory_fits_where_the_rule_says_tc():
    for c in (8, 12, 20, 36, 48, 64):
        for hd in range(1, dprnn.TC_MAX_HIDDEN + 1, 3):
            for f in (1, 7, 24, 64, 200):
                if dprnn.kernel_form(f, c, hd, BF16) == "tc":
                    assert (dprnn.tc_smem_bytes(f, c, hd)
                            <= dprnn.MAX_SMEM_BYTES)


def _case(b, f=5, c=12, hd=6, nb=2, dtype=BF16):
    g = torch.Generator().manual_seed(b)
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dtype)
            for k, s in dprnn.plan_shapes(nb, c, hd).items()}
    x = torch.randn(f, b, c, generator=g).to(dtype)
    h = (torch.randn(nb, f, b, c, generator=g) * 0.5).to(dtype)
    return plan, x, h


def test_launch_tc_refuses_what_the_form_does_not_take():
    plan, x, h = _case(3, dtype=torch.float32)
    with pytest.raises(ValueError, match="tensor-core form does not take"):
        dprnn.launch_tc(plan, x, h)
    plan, x, h = _case(3, c=72, hd=36)
    with pytest.raises(ValueError, match="tensor-core form does not take"):
        dprnn.launch_tc(plan, x, h)


def test_launches_need_the_card():
    plan, x, h = _case(2)
    with pytest.raises(ValueError, match="CUDA device"):
        dprnn.launch_tc(plan, x, h)
    with pytest.raises(ValueError, match="CUDA device"):
        dprnn.launch_scalar(plan, x, h)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cpu_step_is_the_plain_version_and_counts_no_launch(dtype):
    plan, x, h = _case(3, dtype=dtype)
    before = (dprnn.dprnn_stack_step.launches,
              dprnn.dprnn_stack_step.tc_launches)
    got = dprnn.dprnn_stack_step(plan, x, h)
    want = dprnn.dprnn_stack_reference(plan, x, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (dprnn.dprnn_stack_step.launches,
            dprnn.dprnn_stack_step.tc_launches) == before


def test_wrapper_checks_its_operands():
    plan, x, h = _case(2)
    with pytest.raises(ValueError, match="h has shape"):
        dprnn.dprnn_stack_step(plan, x, h[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        dprnn.dprnn_stack_step(plan, x.transpose(0, 1).contiguous()
                               .transpose(0, 1), h)
    bad = dict(plan, w_fhh=plan["w_fhh"].float())
    with pytest.raises(ValueError, match="w_fhh is torch.float32"):
        dprnn.dprnn_stack_step(bad, x, h)
    bad = dict(plan, b_ffc=plan["b_ffc"][:, :, :4].contiguous())
    with pytest.raises(ValueError, match="plan\\['b_ffc'\\] has shape"):
        dprnn.dprnn_stack_step(bad, x, h)
