"""SAM prompt encoder (PyTorch counterpart of walkgpt_tpu/models/sam_prompt.py).

The WalkGPT pipeline prompts SAM with text only: `text_embeds` become the
sparse prompt and the dense prompt is the learned no-mask embedding. The
point, box and mask prompts of the JAX package (the predictor surface) are
not ported yet; their parameters are kept so the trees stay identical.
Dense maps are NHWC.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core import nn
from ..core.config import PromptEncoderConfig


def init(g: torch.Generator, cfg: PromptEncoderConfig, dtype=torch.float32):
    d = cfg.embed_dim
    mc = cfg.mask_in_chans
    return {
        # PositionEmbeddingRandom gaussian matrix (buffer; scale=1), fp32
        "pe_gaussian": nn.normal(g, (2, d // 2), 1.0),
        "point_embeddings": [nn.embedding_init(g, 1, d, std=1.0, dtype=dtype)
                             for _ in range(4)],
        "not_a_point_embed": nn.embedding_init(g, 1, d, std=1.0, dtype=dtype),
        "no_mask_embed": nn.embedding_init(g, 1, d, std=1.0, dtype=dtype),
        "mask_downscaling": {
            "conv1": nn.conv2d_init(g, 1, mc // 4, (2, 2), dtype=dtype),
            "ln1": nn.layer_norm_init(g, mc // 4, dtype),
            "conv2": nn.conv2d_init(g, mc // 4, mc, (2, 2), dtype=dtype),
            "ln2": nn.layer_norm_init(g, mc, dtype),
            "conv3": nn.conv2d_init(g, mc, d, (1, 1), dtype=dtype),
        },
    }


def _pe_encoding(params, coords: torch.Tensor) -> torch.Tensor:
    """coords in [0,1]^2, shape [..., 2] -> [..., embed_dim] (fp32)."""
    coords = 2.0 * coords.float() - 1.0
    coords = coords @ params["pe_gaussian"].float()
    coords = 2.0 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def get_dense_pe(params, cfg: PromptEncoderConfig) -> torch.Tensor:
    """Positional encoding grid [1, H, W, C] (fp32)."""
    h, w = cfg.image_embedding_size
    dev = params["pe_gaussian"].device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                        # [h, w, 2] (x, y)
    return _pe_encoding(params, grid)[None]


def apply(params, cfg: PromptEncoderConfig, *,
          text_embeds: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sparse [B, N, C], dense [B, H, W, C])."""
    h, w = cfg.image_embedding_size
    no_mask = params["no_mask_embed"]["w"]
    if text_embeds is None:
        sparse = torch.zeros((1, 0, cfg.embed_dim), device=no_mask.device)
    else:
        sparse = text_embeds
    dense = no_mask.reshape(1, 1, 1, -1).expand(sparse.shape[0], h, w, cfg.embed_dim)
    return sparse, dense
