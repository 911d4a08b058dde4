"""Multi-scale mask decoder, the PixelLM variant (PyTorch counterpart of
walkgpt_tpu/models/sam_decoder_multiscale.py).

Per-scale TwoWayTransformer copies, a learned level embedding added to the
prompt tokens, and, for levels > 0, a 2x feature upsample gated by the
sigmoid of the previous level's mean mask:
    src = (sigmoid(mean(previous_masks)) + 1) * upsample_2x(src)
with the dense positional encoding recomputed and the dense prompt resized
to the upsampled grid. The multimask slice is [0:None]: every mask token is
kept. Maps are NHWC.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import nn
from ..core.config import MaskDecoderConfig
from ..ops.resize import bilinear_resize
from . import sam_decoder
from .sam_prompt import _pe_encoding


def init(g: torch.Generator, cfg: MaskDecoderConfig, *, image_feature_scale_num: int = 1,
         dtype=torch.float32):
    d = cfg.transformer_dim
    return {
        "transformers": [sam_decoder.twoway_transformer_init(g, cfg, dtype)
                         for _ in range(image_feature_scale_num)],
        "iou_token": nn.embedding_init(g, 1, d, std=1.0, dtype=dtype),
        "mask_tokens": nn.embedding_init(g, cfg.num_mask_tokens, d, std=1.0, dtype=dtype),
        "level_embed": nn.embedding_init(g, image_feature_scale_num, d, std=1.0, dtype=dtype),
        # 8x channel reduction in one stage (the base decoder has two)
        "output_upscaling": {
            "conv": nn.conv_transpose2d_init(g, d, d // 8, (2, 2), dtype=dtype),
            "ln": nn.layer_norm_init(g, d // 8, dtype),
        },
        "upsample_2x": {
            "conv": nn.conv_transpose2d_init(g, d, d, (2, 2), dtype=dtype),
            "ln": nn.layer_norm_init(g, d, dtype),
        },
        "pe_gaussian": nn.normal(g, (2, d // 2), 1.0),
        "hypernet_mlps": [nn.relu_mlp_stack_init(g, [d, d, d, d // 8], dtype=dtype)
                          for _ in range(cfg.num_mask_tokens)],
        "iou_head": nn.relu_mlp_stack_init(
            g, [d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1)
            + [cfg.num_mask_tokens], dtype=dtype),
    }


def _dense_pe(params, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    dev = params["pe_gaussian"].device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return _pe_encoding(params, torch.stack([gx, gy], dim=-1))[None]


def apply(p, cfg: MaskDecoderConfig, *, image_embeddings: torch.Tensor,
          image_pe: torch.Tensor, sparse_prompt: torch.Tensor,
          dense_prompt: torch.Tensor, multimask_output: bool,
          level_num: int, previous_masks: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (masks [B, T, 4H', 4W'], iou [B, T]) with H' = 2H at levels
    > 0; previous_masks [B, T', 2H, 2W] (the previous level's masks) gate
    the upsampled features there."""
    b = sparse_prompt.shape[0]
    d = cfg.transformer_dim
    out_tokens = torch.cat([p["iou_token"]["w"], p["mask_tokens"]["w"]], dim=0)
    tokens = torch.cat([out_tokens[None].expand(b, *out_tokens.shape),
                        sparse_prompt.to(out_tokens.dtype)], dim=1)
    tokens = tokens + p["level_embed"]["w"][level_num]

    src = image_embeddings.expand(b, *image_embeddings.shape[1:])
    if level_num > 0:
        if previous_masks is None:
            raise ValueError("levels above 0 need the previous level's masks")
        u = p["upsample_2x"]
        src = nn.gelu_exact(nn.layer_norm2d(
            u["ln"], nn.conv_transpose2d(u["conv"], src, stride=(2, 2))))
        h, w = src.shape[1], src.shape[2]
        gate = torch.sigmoid(previous_masks.mean(dim=1))[..., None] + 1.0
        src = src * gate
        image_pe = _dense_pe(p, (h, w))
        dense_prompt = bilinear_resize(dense_prompt, (h, w))
    src = src + dense_prompt
    h, w = src.shape[1], src.shape[2]

    hs, src_out = sam_decoder.twoway_transformer(
        p["transformers"][level_num], src, image_pe, tokens, cfg.transformer_num_heads)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + cfg.num_mask_tokens]

    src_maps = src_out.reshape(b, h, w, d)
    up = p["output_upscaling"]
    upscaled = nn.gelu_exact(nn.layer_norm2d(
        up["ln"], nn.conv_transpose2d(up["conv"], src_maps, stride=(2, 2))))
    hyper_in = torch.stack(
        [nn.relu_mlp_stack(p["hypernet_mlps"][i], mask_tokens_out[:, i])
         for i in range(cfg.num_mask_tokens)], dim=1)
    uh, uw, uc = upscaled.shape[1], upscaled.shape[2], upscaled.shape[3]
    dt = torch.promote_types(hyper_in.dtype, upscaled.dtype)
    masks = torch.einsum("btc,bpc->btp", hyper_in.to(dt),
                         upscaled.reshape(b, uh * uw, uc).to(dt)
                         ).reshape(b, cfg.num_mask_tokens, uh, uw)
    iou_pred = nn.relu_mlp_stack(p["iou_head"], iou_token_out)
    sl = slice(0, None) if multimask_output else slice(0, 1)
    return masks[:, sl], iou_pred[:, sl]
