"""Length masking (fastenhancer_tpu/functional/mask.py; reference:
functional/mask.py:4-9)."""
import torch


def get_mask(length: torch.Tensor, max_len: int) -> torch.Tensor:
    """length: [B] int -> boolean mask [B, 1, max_len] on length's device.

    `max_len` is an int, as in the JAX package (which needs it static)."""
    pos = torch.arange(max_len, device=length.device)[None, None, :]
    return pos < length[:, None, None]
