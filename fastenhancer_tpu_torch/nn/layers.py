"""Functional NN layers over plain parameter trees (nested dicts of tensors).

Counterpart of fastenhancer_tpu/nn/layers.py. Weights keep torch layouts
(conv [out, in, k], conv-transpose [in, out, k], linear [out, in]); the
apply functions keep the JAX package's channels-last [N, L, C] activations
at their boundary and transpose to torch's [N, C, L] inside.

Initializers take an explicit `torch.Generator` and `device`: values are
drawn on the CPU from the generator and then moved, so one seed gives the
same weights on every device.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from .. import parallel

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


# ---------------------------------------------------------------------------
# Initializers (torch-default distributions)
# ---------------------------------------------------------------------------

def uniform_init(generator: torch.Generator, shape: tp.Sequence[int],
                 bound: float, device: torch.device) -> Tensor:
    """U(-bound, bound) float32, drawn on the CPU from `generator`."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def torch_linear_init(generator: torch.Generator, out_f: int, in_f: int,
                      bias: bool, device: torch.device) -> Params:
    """nn.Linear default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(in))."""
    bound = 1.0 / in_f ** 0.5
    p = {"weight": uniform_init(generator, (out_f, in_f), bound, device)}
    if bias:
        p["bias"] = uniform_init(generator, (out_f,), bound, device)
    return p


def torch_conv1d_init(generator: torch.Generator, out_ch: int, in_ch: int,
                      kernel: int, bias: bool, device: torch.device) -> Params:
    bound = 1.0 / (in_ch * kernel) ** 0.5
    p = {"weight": uniform_init(generator, (out_ch, in_ch, kernel), bound,
                                device)}
    if bias:
        p["bias"] = uniform_init(generator, (out_ch,), bound, device)
    return p


def torch_convtranspose1d_init(generator: torch.Generator, in_ch: int,
                               out_ch: int, kernel: int, bias: bool,
                               device: torch.device) -> Params:
    """nn.ConvTranspose1d layout [in, out, k]; fan_in uses out * k."""
    bound = 1.0 / (out_ch * kernel) ** 0.5
    p = {"weight": uniform_init(generator, (in_ch, out_ch, kernel), bound,
                                device)}
    if bias:
        p["bias"] = uniform_init(generator, (out_ch,), bound, device)
    return p


def init_batch_norm(c: int, device: torch.device, affine: bool = True
                    ) -> tp.Tuple[tp.Optional[Params], Params]:
    params = ({"weight": torch.ones(c, device=device),
               "bias": torch.zeros(c, device=device)} if affine else None)
    stats = {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)}
    return params, stats


# ---------------------------------------------------------------------------
# Linear / conv (channels-last at the boundary)
# ---------------------------------------------------------------------------

def linear(params: Params, x: Tensor) -> Tensor:
    """x: [..., in] @ weight[out, in].T (+ bias)."""
    y = x @ params["weight"].T
    if "bias" in params:
        y = y + params["bias"]
    return y


def conv1d_cl(params: Params, x: Tensor, stride: int = 1,
              padding: int = 0) -> Tensor:
    """1-D conv over the length axis; x: [N, L, Cin] -> [N, L', Cout].
    Weight in torch layout [Cout, Cin, K]."""
    y = F.conv1d(x.transpose(1, 2), params["weight"], params.get("bias"),
                 stride=stride, padding=padding)
    return y.transpose(1, 2)


def conv_transpose1d_cl(params: Params, x: Tensor, stride: int = 1,
                        padding: int = 0, output_padding: int = 0) -> Tensor:
    """1-D transposed conv; x: [N, L, Cin] ->
    [N, (L-1)*s + K - 2*pad + output_padding, Cout]. Weight [Cin, Cout, K]."""
    y = F.conv_transpose1d(x.transpose(1, 2), params["weight"],
                           params.get("bias"), stride=stride, padding=padding,
                           output_padding=output_padding)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# BatchNorm (torch BatchNorm1d semantics; statistics live in a separate tree)
# ---------------------------------------------------------------------------

def batch_norm(params: tp.Optional[Params], stats: Params, x: Tensor, *,
               train: bool, momentum: float = 0.1, eps: float = 1e-5,
               weight: tp.Optional[Tensor] = None
               ) -> tp.Tuple[Tensor, Params]:
    """Normalize over every axis but the last (channel) one.

    params: {"weight", "bias"} or None (affine=False); stats: running
    {"mean", "var"} (the unbiased variance, as torch stores it). Train mode
    normalizes with the batch's statistics and returns the running ones
    moved by `momentum`; `weight`, broadcastable to x.shape[:-1] + (1,),
    includes (1) or excludes (0) each position from those statistics (the
    row mask of zero-padded batch rows). Under several ranks
    (`parallel.world() > 1`) train mode takes the statistics of every
    rank's batch: the sums [sum w*x, sum w*x^2, sum w] are all-reduced,
    differentiably, before the mean and variance are formed, so every rank
    normalises alike and moves its running statistics alike. Eval mode
    uses the running statistics and returns `stats` unchanged. Statistics
    and normalization run in float32; the output has x's dtype."""
    in_dtype = x.dtype
    xf = x.float()
    if train:
        red = tuple(range(x.ndim - 1))
        c = x.shape[-1]
        if parallel.world() > 1:
            w = (xf.new_ones(()) if weight is None
                 else weight.float()).expand(*x.shape[:-1], 1)
            sums = parallel.all_reduce_sum(torch.cat([
                (xf * w).sum(dim=red), (xf.square() * w).sum(dim=red),
                w.sum().reshape(1)]))
            n = sums[2 * c].clamp_min(1.0)
            mean = sums[:c] / n
            var = sums[c:2 * c] / n - mean.square()
            unbiased = var * (n / (n - 1.0).clamp_min(1.0))
        elif weight is None:
            mean = xf.mean(dim=red)
            var = xf.square().mean(dim=red) - mean.square()
            n = x.numel() // x.shape[-1]
            unbiased = var * (n / max(n - 1, 1))
        else:
            w = weight.float().expand(*x.shape[:-1], 1)
            n = w.sum().clamp_min(1.0)
            mean = (xf * w).sum(dim=red) / n
            var = (xf.square() * w).sum(dim=red) / n - mean.square()
            unbiased = var * (n / (n - 1.0).clamp_min(1.0))
        stats = {"mean": (1 - momentum) * stats["mean"] + momentum * mean,
                 "var": (1 - momentum) * stats["var"] + momentum * unbiased}
    else:
        mean, var = stats["mean"], stats["var"]
    y = (xf - mean) * torch.rsqrt(var.float() + eps)
    if params is not None:
        y = y * params["weight"] + params["bias"]
    return y.to(in_dtype), stats


def layer_norm_fc(params: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """Normalize over the last TWO axes (freq, channel) with a per-channel
    affine: the ln ablation's GroupNorm(1, C) on the conv units. Statistics
    in float32, output in x's dtype."""
    in_dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    diff = xf - mean
    var = diff.square().mean(dim=(-2, -1), keepdim=True)
    y = diff * torch.rsqrt(var + eps) * params["weight"] + params["bias"]
    return y.to(in_dtype)


def init_layer_norm(c: int, device: torch.device) -> Params:
    return {"weight": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


# ---------------------------------------------------------------------------
# Weight norm (torch parametrization: w = g * v / ||v||, norm over dims != 0)
# ---------------------------------------------------------------------------

def wn_weight(wn: Params) -> Tensor:
    """{"g": [out, 1, ...], "v": weight-shaped} -> effective weight."""
    v = wn["v"]
    dims = tuple(range(1, v.ndim))
    return wn["g"] * v / v.square().sum(dim=dims, keepdim=True).sqrt()


def to_wn(weight: Tensor) -> Params:
    """Decompose a plain weight into {g, v} (torch weight_norm init)."""
    dims = tuple(range(1, weight.ndim))
    return {"g": weight.square().sum(dim=dims, keepdim=True).sqrt(),
            "v": weight}


def maybe_wn_weight(params: Params, name: str = "weight") -> Tensor:
    """`params[name]`, resolving a weight-norm {g, v} dict."""
    w = params[name]
    if isinstance(w, dict):
        return wn_weight(w)
    return w


# ---------------------------------------------------------------------------
# Activations (the JAX package's choices: GELU is the tanh approximation)
# ---------------------------------------------------------------------------

_ACTIVATIONS: tp.Dict[str, tp.Callable[[Tensor], Tensor]] = {
    "ReLU": F.relu,
    "SiLU": F.silu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "ELU": F.elu,
    "Identity": lambda x: x,
}


def get_activation(name: str) -> tp.Callable[[Tensor], Tensor]:
    fn = _ACTIVATIONS.get(name)
    if fn is None:
        raise ValueError(f"unsupported activation: {name}")
    return fn
