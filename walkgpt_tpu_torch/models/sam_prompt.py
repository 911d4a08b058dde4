"""SAM prompt encoder (PyTorch counterpart of walkgpt_tpu/models/sam_prompt.py).

The WalkGPT pipeline prompts SAM with text only: `text_embeds` become the
sparse prompt and the dense prompt is the learned no-mask embedding. The
predictor surface (models/sam_predictor.py) also prompts with points
(`embed_points`; a not-a-point pad token only when no box comes with them),
boxes (`embed_boxes`, two corner tokens) and low-res masks (`embed_masks`,
three stride-2 / 1x1 VALID convs down to the embedding grid). The sparse
prompt is [points, boxes, text] in that order. Dense maps are NHWC.
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


def _input_scale(cfg: PromptEncoderConfig, device) -> torch.Tensor:
    """(W, H) of the model input frame, which (x, y) coordinates divide."""
    return torch.tensor([cfg.input_image_size[1], cfg.input_image_size[0]],
                        dtype=torch.float32, device=device)


def embed_points(params, cfg: PromptEncoderConfig, points: torch.Tensor,
                 labels: torch.Tensor, pad: bool) -> torch.Tensor:
    """points [B, N, 2] (x, y) in the input frame, labels [B, N] (1 fg, 0 bg,
    -1 not a point) -> [B, N (+1 with pad), C]."""
    pts = points.float() + 0.5
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pts.shape[0], 1, 2))], dim=1)
        labels = torch.cat([labels, -labels.new_ones((labels.shape[0], 1))], dim=1)
    pe = _pe_encoding(params, pts / _input_scale(cfg, pts.device))
    lab = labels[..., None]
    pe = torch.where(lab == -1, params["not_a_point_embed"]["w"][0].float(), pe)
    pe = torch.where(lab == 0, pe + params["point_embeddings"][0]["w"][0].float(), pe)
    pe = torch.where(lab == 1, pe + params["point_embeddings"][1]["w"][0].float(), pe)
    return pe


def embed_boxes(params, cfg: PromptEncoderConfig, boxes: torch.Tensor) -> torch.Tensor:
    """boxes [B, 4] XYXY in the input frame -> [B, 2, C] corner tokens."""
    coords = (boxes.float() + 0.5).reshape(-1, 2, 2)
    pe = _pe_encoding(params, coords / _input_scale(cfg, coords.device))
    corner = torch.stack([params["point_embeddings"][2]["w"][0],
                          params["point_embeddings"][3]["w"][0]]).float()
    return pe + corner


def embed_masks(params, masks: torch.Tensor) -> torch.Tensor:
    """masks: [B, 4H, 4W, 1] NHWC -> dense embeddings [B, H, W, C]."""
    md = params["mask_downscaling"]
    x = nn.conv2d(md["conv1"], masks, stride=(2, 2), padding="VALID")
    x = nn.gelu_exact(nn.layer_norm2d(md["ln1"], x))
    x = nn.conv2d(md["conv2"], x, stride=(2, 2), padding="VALID")
    x = nn.gelu_exact(nn.layer_norm2d(md["ln2"], x))
    return nn.conv2d(md["conv3"], x, padding="VALID")


def apply(params, cfg: PromptEncoderConfig, *,
          points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          boxes: Optional[torch.Tensor] = None,
          masks: Optional[torch.Tensor] = None,
          text_embeds: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sparse [B, N, C], dense [B, H, W, C])."""
    lead = next((x for x in (points[0] if points is not None else None, boxes, masks,
                             text_embeds) if x is not None), None)
    bs = 1 if lead is None else lead.shape[0]
    no_mask = params["no_mask_embed"]["w"]
    parts = []
    if points is not None:
        parts.append(embed_points(params, cfg, points[0], points[1], pad=boxes is None))
    if boxes is not None:
        parts.append(embed_boxes(params, cfg, boxes))
    if text_embeds is not None:
        parts.append(text_embeds)
    if not parts:
        sparse = torch.zeros((bs, 0, cfg.embed_dim), device=no_mask.device)
    elif len(parts) == 1:
        sparse = parts[0]
    else:
        dt = parts[0].dtype
        for x in parts[1:]:
            dt = torch.promote_types(dt, x.dtype)
        sparse = torch.cat([x.to(dt) for x in parts], dim=1)
    if masks is not None:
        dense = embed_masks(params, masks)
    else:
        h, w = cfg.image_embedding_size
        dense = no_mask.reshape(1, 1, 1, -1).expand(bs, h, w, cfg.embed_dim)
    return sparse, dense
