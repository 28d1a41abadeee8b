"""The BSRNN stack wrapper's choice of kernel form and its tensor-core
form's sizes and argument checks, on the CPU (no JAX, no card).

The kernel's arithmetic against the JAX package is in test_torch_bsrnn.py;
the forms against the plain version on the card are in
test_torch_cuda_kernels.py.
"""
import pytest
import torch

from fastenhancer_tpu_torch.ops import bsrnn_stack as band

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

BF16 = torch.bfloat16


@pytest.mark.parametrize("name,c", [("BSRNN-S", 64), ("BSRNN-XT", 16)])
def test_bsrnn_configs_run_the_tc_form_in_bf16(name, c):
    assert band.kernel_form(31, c, 2 * c, BF16) == "tc", name
    assert band.kernel_form(31, c, 2 * c, torch.float32) == "scalar", name


@pytest.mark.parametrize("bands,c,hd", [
    (5, 128, 256),   # H = 256: W_hh[d] alone is 528 KB
    (31, 24, 48),    # C and H not multiples of 16
    (31, 64, 136),   # H not a multiple of 16
    (31, 80, 128),   # C > 64
    (31, 64, 144),   # H > 128
    (700, 64, 128)])  # the x tile outgrows shared memory
def test_other_shapes_run_the_scalar_form(bands, c, hd):
    assert band.kernel_form(bands, c, hd, BF16) == "scalar"
    assert band.kernel_form(bands, c, hd, torch.float32) == "scalar"


@pytest.mark.parametrize("bands,c,hd,want", [
    # zero chunk + x tile + h double buffer + the largest phase: the time
    # cell's h and c/h' rows of a chunk and its three ring slots
    (31, 64, 128, 2 * (8 + 248 * 72 + 2 * 8 * 136
                       + 2 * 128 * 136 + 3 * 192 * 72)),
    (31, 16, 32, 2 * (8 + 248 * 24 + 2 * 8 * 40
                      + 2 * 128 * 40 + 3 * 48 * 72)),
    # at H = 128 and C = 16 W_hh[d] (128 rows of 520) is the largest
    (31, 16, 128, 2 * (8 + 248 * 24 + 2 * 8 * 136 + 128 * 520))])
def test_tc_smem_bytes(bands, c, hd, want):
    assert band.tc_smem_bytes(bands, c, hd) == want
    assert want <= band.MAX_SMEM_BYTES


def test_tc_shared_memory_fits_where_the_rule_says_tc():
    for c in range(16, band.TC_MAX_CHANNELS + 1, 16):
        for hd in range(16, band.TC_MAX_HIDDEN + 1, 16):
            for bands in (1, 7, 31, 64):
                if band.kernel_form(bands, c, hd, BF16) == "tc":
                    assert (band.tc_smem_bytes(bands, c, hd)
                            <= band.MAX_SMEM_BYTES)


@pytest.mark.parametrize("b,tiles", [(1, 1), (13, 2), (256, 32), (257, 33),
                                     (1024, 128)])
def test_tc_workspace_shapes(b, tiles):
    xp, ys = band.tc_workspace_shapes(b, 31, 128)
    assert xp == (tiles, 2, 31, 8, 32, 16)
    assert ys == (tiles, 31 * 8, 256)
    # xp holds each tile's [2, F, 8, 4H] input projection; at 256 streams
    # of BSRNN-S the two stay in the H100's 50 MB L2
    assert xp[3] * xp[4] * xp[5] == 8 * 4 * 128
    if b == 256:
        assert 2 * (torch.Size(xp).numel() + torch.Size(ys).numel()) < 50e6


def _case(b, c=16, nl=1, bands=5, dtype=BF16):
    hd = 2 * c
    g = torch.Generator().manual_seed(b)
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dtype)
            for k, s in band.plan_shapes(nl, c, hd).items()}
    x = torch.randn(bands, b, c, generator=g).to(dtype)
    h = (torch.randn(nl, 2, bands, b, hd, generator=g) * 0.5).to(dtype)
    return plan, x, h


def test_launch_tc_checks_its_workspaces():
    plan, x, h = _case(3)
    xp, ys = band.tc_workspace(3, 5, 32, x.device)
    with pytest.raises(ValueError, match="xp_ws must be"):
        band.launch_tc(plan, x, h, xp[:, :1].contiguous(), ys)
    with pytest.raises(ValueError, match="ys_ws must be"):
        band.launch_tc(plan, x, h, xp, ys.float())
    with pytest.raises(ValueError, match="ys_ws must be"):
        band.launch_tc(plan, x, h, xp, ys.transpose(0, 1))
    with pytest.raises(ValueError, match="xp_ws must be"):
        band.launch_tc(plan, x, h, *band.tc_workspace(9, 5, 32, x.device))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.empty(ys.numel() + 1, dtype=BF16)
        band.launch_tc(plan, x, h, xp, flat[1:].view(ys.shape))
    # everything right, but the kernel has no CPU mode
    with pytest.raises(ValueError, match="CUDA device"):
        band.launch_tc(plan, x, h, xp, ys)


def test_launch_tc_refuses_what_the_form_does_not_take():
    xp, ys = band.tc_workspace(3, 5, 32, torch.device("cpu"))
    plan, x, h = _case(3, dtype=torch.float32)
    with pytest.raises(ValueError, match="tensor-core form does not take"):
        band.launch_tc(plan, x, h, xp, ys)
    plan, x, h = _case(3, c=24)
    with pytest.raises(ValueError, match="tensor-core form does not take"):
        band.launch_tc(plan, x, h, xp, ys)


def test_launch_scalar_needs_the_card():
    plan, x, h = _case(2, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        band.launch_scalar(plan, x, h)


def test_cpu_step_is_the_plain_version_and_counts_no_launch():
    plan, x, h = _case(3, nl=2)
    before = (band.bsrnn_stack_step.launches,
              band.bsrnn_stack_step.tc_launches)
    got = band.bsrnn_stack_step(plan, x, h)
    want = band.bsrnn_stack_reference(plan, x, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (band.bsrnn_stack_step.launches,
            band.bsrnn_stack_step.tc_launches) == before
