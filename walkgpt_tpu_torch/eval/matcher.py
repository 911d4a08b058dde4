"""Hungarian mask matching for multi-[SEG] evaluation (PyTorch counterpart of
walkgpt_tpu/eval/matcher.py).

Both mask sets are point-sampled at 12,544 shared random locations
(bilinear grid-sample, align_corners=False, zero padding) drawn from
np.random.RandomState(seed); the costs are batch BCE + batch dice (the
+1-smoothed variant), computed in torch on the masks' device; the
assignment is scipy's linear_sum_assignment on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def grid_sample_bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """torch F.grid_sample(align_corners=False, padding_mode='zeros') on
    [N, H, W] images at [P, 2] normalized coords in [-1, 1] ((x, y) order),
    written out as the JAX package writes it. Returns [N, P]."""
    n, h, w = img.shape
    x = (coords[:, 0] + 1.0) * w / 2.0 - 0.5
    y = (coords[:, 1] + 1.0) * h / 2.0 - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0

    def fetch(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yi_c = yi.clamp(0, h - 1).long()
        xi_c = xi.clamp(0, w - 1).long()
        vals = img[:, yi_c, xi_c]                       # [N, P]
        return torch.where(inside[None, :], vals, vals.new_zeros(()))

    v00 = fetch(y0, x0)
    v01 = fetch(y0, x0 + 1)
    v10 = fetch(y0 + 1, x0)
    v11 = fetch(y0 + 1, x0 + 1)
    return (v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy)
            + v10 * (1 - dx) * dy + v11 * dx * dy)


def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[N, P] logits vs [M, P] binary -> [N, M] (+1-smoothed dice)."""
    p = torch.sigmoid(inputs.float())
    t = targets.float()
    numerator = 2.0 * (p @ t.T)
    denominator = p.sum(-1)[:, None] + t.sum(-1)[None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def batch_bce_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[N, P] logits vs [M, P] binary -> [N, M] mean BCE under each pairing."""
    x = inputs.float()
    hw = x.shape[1]
    soft = torch.log1p(torch.exp(-x.abs()))
    pos = x.clamp(min=0) - x + soft                     # BCE against 1
    neg = x.clamp(min=0) + soft                         # BCE against 0
    t = targets.float()
    return (pos @ t.T + neg @ (1.0 - t).T) / hw


def match_pred(out_mask, tgt_mask, *, num_points: int = 12544, seed: int = 0,
               device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian assignment between predicted mask logits [N, H, W] and GT
    binary masks [M, H', W'] (arrays or tensors; the costs are computed on
    `device`, by default out_mask's, else the CPU). Returns (pred_indices,
    tgt_indices)."""
    from scipy.optimize import linear_sum_assignment
    if device is None:
        device = out_mask.device if isinstance(out_mask, torch.Tensor) else "cpu"
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor(rng.rand(num_points, 2).astype(np.float32), device=device)
    coords = 2.0 * pts - 1.0
    out_s = grid_sample_bilinear(torch.as_tensor(out_mask, device=device).float(), coords)
    tgt_s = grid_sample_bilinear(torch.as_tensor(tgt_mask, device=device).float(), coords)
    cost = batch_bce_cost(out_s, tgt_s) + batch_dice_cost(out_s, tgt_s)
    return linear_sum_assignment(cost.cpu().numpy())
