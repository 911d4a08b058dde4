"""Resize ops with the JAX package's numerics (`walkgpt_tpu/ops/resize.py`).

jax.image.resize(method="linear", antialias=False) uses half-pixel centres,
which is torch's F.interpolate(mode="bilinear", align_corners=False,
antialias=False). `nearest_resize` is torch's mode="nearest" floor indexing
as an explicit gather, as the JAX package writes it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the spatial dims of [..., H, W, C] channel-last tensors.

    Computed in fp32 and cast back."""
    *lead, h, w, c = x.shape
    y = x.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(size_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    y = y.permute(0, 2, 3, 1).reshape(*lead, size_hw[0], size_hw[1], c)
    return y.to(x.dtype)


def nearest_resize(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') floor indexing for [..., H, W]
    tensors: source index floor(i * (in / out)), in float32 as the JAX
    package computes it."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = size_hw
    rows = torch.floor(torch.arange(h_out, dtype=torch.float32, device=x.device)
                       * (h_in / h_out)).long()
    cols = torch.floor(torch.arange(w_out, dtype=torch.float32, device=x.device)
                       * (w_in / w_out)).long()
    return x[..., rows[:, None], cols[None, :]]
