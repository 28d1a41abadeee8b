"""AdamP, AdamW and Adam updates of one tensor, as functions on tensors.

Counterpart of fastenhancer_tpu/optim/adamp.py. AdamP (Heo et al., "AdamP:
Slowing Down the Slowdown for Momentum Optimizers on Scale-invariant
Weights", ICLR 2021) removes the radial component of the update of a
scale-invariant weight by projecting the step onto the weight's tangent
space. Projection modes:
  "auto"        - channelwise if |cos| < delta/sqrt(cols), else layerwise if
                  |cos| < delta/sqrt(numel), else none; both projections are
                  computed and one is chosen with torch.where, as the JAX
                  package does, so the step needs no host round trip;
  "disabled"    - the plain Adam(W)-style update;
  "channelwise" - project each output channel (dim 0 row);
  "layerwise"   - project the flattened tensor;
  int d         - project over every dim but d.
Each function returns (new_p, new_m, new_v) and computes in float32
scalars where the JAX functions do (step, lr, bias corrections).
`optimizer.GroupedOptimizer` applies them in place.
"""
from __future__ import annotations

import math
import typing as tp

import torch

Tensor = torch.Tensor


def _channel_project(p2d: Tensor, perturb2d: Tensor, eps: float) -> Tensor:
    """Remove the component of perturb along each row of p; [C, L] each."""
    p_n = p2d / (torch.linalg.vector_norm(p2d, dim=1, keepdim=True) + eps)
    return perturb2d - p_n * (p_n * perturb2d).sum(dim=1, keepdim=True)


def _layer_project(pf: Tensor, perturbf: Tensor, eps: float) -> Tensor:
    """Remove the component of perturb along the flattened p; [L] each."""
    p_n = pf / (torch.linalg.vector_norm(pf) + eps)
    return perturbf - p_n * (p_n * perturbf).sum()


def _dim_project(p: Tensor, perturb: Tensor, keep_dim: int,
                 eps: float) -> Tensor:
    # torch reduces over all dims when the list of dims is empty
    dims = tuple(i for i in range(p.ndim) if i != keep_dim) or None
    p_n = p / (p.square().sum(dim=dims, keepdim=True).sqrt() + eps)
    return perturb - p_n * (p_n * perturb).sum(dim=dims, keepdim=True)


def _abs_cos(x: Tensor, y: Tensor, dim: int, eps: float) -> Tensor:
    """|F.cosine_similarity|: |x.y| / max(||x|| ||y||, eps) along dim."""
    dot = (x * y).sum(dim=dim)
    den = (torch.linalg.vector_norm(x, dim=dim)
           * torch.linalg.vector_norm(y, dim=dim))
    return (dot / den.clamp_min(eps)).abs()


def _bias_corrections(step: Tensor, beta1: float, beta2: float
                      ) -> tp.Tuple[Tensor, Tensor]:
    stepf = step.float()
    return 1.0 - beta1 ** stepf, 1.0 - beta2 ** stepf


def adamp_leaf_update(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                      step: Tensor, lr: Tensor, *, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-8,
                      weight_decay: float = 0.0, delta: float = 0.1,
                      wd_ratio: float = 0.1, nesterov: bool = False,
                      projection: tp.Union[str, int] = "auto"
                      ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """One AdamP step of one tensor: Adam moments -> perturbation ->
    optional tangent projection -> decoupled weight decay scaled by
    wd_ratio -> the step. `step` counts this step (1 first)."""
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    denom = v.sqrt() / bc2.sqrt() + eps
    step_size = lr / bc1
    if nesterov:
        perturb = (beta1 * m + (1.0 - beta1) * g) / denom
    else:
        perturb = m / denom

    ratio: tp.Union[float, Tensor] = 1.0
    if p.numel() == 1 or projection == "disabled":
        pass
    elif projection == "channelwise":
        x = p.reshape(p.shape[0], -1)
        perturb = _channel_project(x, perturb.reshape(x.shape),
                                   eps).reshape(p.shape)
        ratio = wd_ratio
    elif projection == "layerwise":
        perturb = _layer_project(p.reshape(-1), perturb.reshape(-1),
                                 eps).reshape(p.shape)
        ratio = wd_ratio
    elif isinstance(projection, int):
        perturb = _dim_project(p, perturb, projection, eps)
        ratio = wd_ratio
    elif projection == "auto":
        pf, yf = p.reshape(-1), perturb.reshape(-1)
        use_layer = _abs_cos(pf, yf, 0, eps) < delta / math.sqrt(pf.numel())
        layer_p = _layer_project(pf, yf, eps).reshape(p.shape)
        if p.ndim > 1:
            x = p.reshape(p.shape[0], -1)
            y = perturb.reshape(x.shape)
            use_chan = (_abs_cos(x, y, 1, eps).amax()
                        < delta / math.sqrt(x.shape[1]))
            chan_p = _channel_project(x, y, eps).reshape(p.shape)
            perturb = torch.where(use_chan, chan_p,
                                  torch.where(use_layer, layer_p, perturb))
            projected = use_chan | use_layer
        else:
            perturb = torch.where(use_layer, layer_p, perturb)
            projected = use_layer
        ratio = torch.where(projected, wd_ratio, 1.0).to(p.dtype)
    else:
        raise ValueError(f"bad projection: {projection!r}")

    if weight_decay > 0:
        p = p * (1.0 - lr * weight_decay * ratio)
    return p - step_size * perturb, m, v


def adamw_leaf_update(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                      step: Tensor, lr: Tensor, *, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-8,
                      weight_decay: float = 0.01, **_unused: tp.Any
                      ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """torch.optim.AdamW semantics (decoupled decay before the step)."""
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    p = p * (1.0 - lr * weight_decay)
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    denom = v.sqrt() / bc2.sqrt() + eps
    return p - (lr / bc1) * (m / denom), m, v


def adam_leaf_update(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                     step: Tensor, lr: Tensor, *, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0, **_unused: tp.Any
                     ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """torch.optim.Adam semantics (L2 decay added to the gradient)."""
    if weight_decay > 0:
        g = g + weight_decay * p
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    denom = v.sqrt() / bc2.sqrt() + eps
    return p - (lr / bc1) * (m / denom), m, v
