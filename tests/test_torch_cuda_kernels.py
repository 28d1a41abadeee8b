"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA CUDA device (`cuda` marker) and skips
without one. The file imports torch and the port only, no JAX, so it runs on
a machine without JAX; tests/conftest.py imports jax, so run it there as

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: float32 1e-5 absolute (TF32 off); bfloat16 2^-5 of the largest
magnitude (a few bf16 ulps: the kernel and cuBLAS sum in different orders,
so a sum on a rounding boundary can round either way and carry on).
"""
import pytest
import torch

from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.ops import rnnformer_stack as stack

pytestmark = pytest.mark.cuda

TINY_KWARGS = dict(
    channels=12, kernel_size=[4, 3], stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2),
    n_fft=128, hop_size=64, win_size=128, weight_norm=True,
    pre_post_init="linear_fixed",
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _random_case(b, f, c, nb, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(
        device, dtype) for k, s in stack.plan_shapes(nb, f, c).items()}
    x = torch.randn(b, f, c, generator=g).to(device, dtype)
    h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(device, dtype)
    return plan, x, h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,c,nb", [(256, 24, 36, 3), (8, 16, 20, 2),
                                      (8, 36, 48, 3), (3, 13, 12, 2)])
def test_stack_kernel_matches_plain(cuda_device, dtype, b, f, c, nb):
    """FE_B, FE_T and FE_S block shapes, and an odd F with H=4, d=3."""
    plan, x, h = _random_case(b, f, c, nb, dtype, cuda_device, seed=b + f)
    before = stack.rnnformer_stack_step.launches
    xo, ho = stack.rnnformer_stack_step(plan, x, h, 4)
    torch.cuda.synchronize()
    assert stack.rnnformer_stack_step.launches == before + 1
    xr, hr = stack.rnnformer_stack_reference(plan, x, h, 4)
    for got, want in ((xo, xr), (ho, hr)):
        assert got.dtype == dtype and got.device == cuda_device
        want = want.float()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -5 * want.abs().max()
        assert (got.float() - want).abs().max() <= tol


def test_stack_kernel_rejects_what_it_cannot_take(cuda_device):
    plan, x, h = _random_case(2, 8, 8, 2, torch.float16, cuda_device, seed=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stack.rnnformer_stack_step(plan, x, h, 2)
    plan, x, h = _random_case(1, 256, 64, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="shared memory"):
        stack.rnnformer_stack_step(plan, x, h, 4)


def test_fused_stream_matches_unfused_on_card(cuda_device):
    """A tiny model's stream() through the kernel equals the unfused plain
    path in float32 (1e-4 on stream outputs)."""
    model = get_model("fastenhancer.default", **TINY_KWARGS)
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   cuda_device))
    wav = torch.randn(3, 64 * 12, generator=torch.Generator().manual_seed(1))
    wav = (wav * 0.3).to(cuda_device)
    before = stack.rnnformer_stack_step.launches
    y_fused = model.stream(folded, wav,
                           fused_plan=model.build_stack_plan(folded))
    assert stack.rnnformer_stack_step.launches == before + 12
    y_plain = model.stream(folded, wav)
    assert (y_fused - y_plain).abs().max() <= 1e-4
