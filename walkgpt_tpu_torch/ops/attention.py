"""Attention ops (PyTorch counterpart of `walkgpt_tpu/ops/attention.py`).

`mha` is the plain einsum attention (fp32 logits and softmax) used by the
small modules, the decode step and the non-kernel paths; the CUDA kernels in
ops/flash_attention.py take its place on the hot paths. Windowed-attention
helpers and the decomposed relative-position bias follow the upstream SAM
encoder.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        bias: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over [B, H, N, D] tensors.

    bias: additive logits bias broadcastable to [B, H, Nq, Nk].
    mask: boolean, True = attend, broadcastable to [B, H, Nq, Nk].
    Logits in fp32 (q * scale rounded in q's dtype, as in the JAX package);
    probabilities cast to v's dtype for the value product.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H] (a view)."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]"""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


# ---------------------------------------------------------------------------
# window partitioning (SAM ViT)
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> [B*nW, ws, ws, C] with bottom/right zero padding."""
    b, h, w, c = x.shape
    pad_h = (-h) % window
    pad_w = (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of window_partition; removes padding."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


# ---------------------------------------------------------------------------
# decomposed relative-position bias (SAM ViT / MViTv2)
# ---------------------------------------------------------------------------

def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Select (and if necessary linearly resample) relative position
    embeddings: [2*max(q,k)-1, D] -> [q_size, k_size, D]."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.float().T[None], size=max_rel_dist,
                                mode="linear", align_corners=False
                                )[0].T.to(rel_pos.dtype)
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def decomposed_rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor,
                            rel_pos_w: torch.Tensor, q_size: Tuple[int, int],
                            k_size: Tuple[int, int]) -> torch.Tensor:
    """Additive attention bias from decomposed rel-pos embeddings.

    q: [B, H, qh*qw, D] per-head queries. Returns [B, H, qh*qw, kh*kw] fp32.
    """
    qh, qw = q_size
    kh, kw = k_size
    rh = get_rel_pos(qh, kh, rel_pos_h)          # [qh, kh, D]
    rw = get_rel_pos(qw, kw, rel_pos_w)          # [qw, kw, D]
    b, h, _, d = q.shape
    r_q = q.reshape(b, h, qh, qw, d).float()
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh.float())
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw.float())
    bias = rel_h[..., :, None] + rel_w[..., None, :]   # [B,H,qh,qw,kh,kw]
    return bias.reshape(b, h, qh * qw, kh * kw)
