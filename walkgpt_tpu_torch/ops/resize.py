"""Resize ops with the JAX package's numerics (`walkgpt_tpu/ops/resize.py`).

jax.image.resize(method="linear", antialias=False) uses half-pixel centres,
which is torch's F.interpolate(mode="bilinear", align_corners=False,
antialias=False).
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
