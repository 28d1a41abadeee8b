"""Frequency-axis multi-head self-attention (head-dim form).

Counterpart of fastenhancer_tpu/nn/attention.py:25-51. The JAX package's
masked-lane branch is a TPU lane-tile trick, bit-identical to this form, and
is not ported.
"""
from __future__ import annotations

import math
import typing as tp

import torch

from .layers import maybe_wn_weight, torch_linear_init

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def init_attention(generator: torch.Generator, channels: int,
                   attn_bias: bool, device: torch.device) -> Params:
    return {"qkv": torch_linear_init(generator, channels * 3, channels,
                                     attn_bias, device)}


def attention(params: Params, x: Tensor, num_heads: int) -> Tensor:
    """x: [N, F, C] -> [N, F, C]. qkv weight [3C, C] (optionally
    weight-normed); after the head reshape the last dim is [q|k|v] per head,
    the reference's split convention."""
    n, f, c = x.shape
    qkv = x @ maybe_wn_weight(params["qkv"], "weight").T
    if "bias" in params["qkv"]:
        qkv = qkv + params["qkv"]["bias"]
    d = c // num_heads
    qkv = qkv.reshape(n, f, num_heads, 3 * d)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    logits = torch.einsum("nfhd,nghd->nhfg", q, k) * (1.0 / math.sqrt(d))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("nhfg,nghd->nfhd", probs, v).reshape(n, f, c)
