"""SAM mask decoder + two-way transformer (PyTorch counterpart of
walkgpt_tpu/models/sam_decoder.py). Dense maps are NHWC; the transformer
works on [B, HW, C] token sequences with the plain einsum attention.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core import nn
from ..core.config import MaskDecoderConfig
from ..ops.attention import merge_heads, mha, split_heads


# ---------------------------------------------------------------------------
# downsampled attention
# ---------------------------------------------------------------------------

def _attn_init(g, d_model: int, downsample: int, dtype):
    d_int = d_model // downsample
    return {
        "q": nn.linear_init(g, d_model, d_int, dtype=dtype),
        "k": nn.linear_init(g, d_model, d_int, dtype=dtype),
        "v": nn.linear_init(g, d_model, d_int, dtype=dtype),
        "out": nn.linear_init(g, d_int, d_model, dtype=dtype),
    }


def _attn(p, q, k, v, nh):
    qh = split_heads(nn.linear(p["q"], q), nh)
    kh = split_heads(nn.linear(p["k"], k), nh)
    vh = split_heads(nn.linear(p["v"], v), nh)
    return nn.linear(p["out"], merge_heads(mha(qh, kh, vh)))


# ---------------------------------------------------------------------------
# two-way transformer
# ---------------------------------------------------------------------------

def _twoway_block_init(g, cfg: MaskDecoderConfig, dtype):
    d = cfg.transformer_dim
    ds = cfg.attention_downsample_rate
    return {
        "self_attn": _attn_init(g, d, 1, dtype),
        "norm1": nn.layer_norm_init(g, d, dtype),
        "cross_t2i": _attn_init(g, d, ds, dtype),
        "norm2": nn.layer_norm_init(g, d, dtype),
        "mlp": nn.mlp_init(g, d, cfg.transformer_mlp_dim, dtype=dtype),
        "norm3": nn.layer_norm_init(g, d, dtype),
        "cross_i2t": _attn_init(g, d, ds, dtype),
        "norm4": nn.layer_norm_init(g, d, dtype),
    }


def _twoway_block(p, queries, keys, query_pe, key_pe, nh, skip_first_layer_pe: bool):
    if skip_first_layer_pe:
        queries = _attn(p["self_attn"], queries, queries, queries, nh)
    else:
        q = queries + query_pe
        queries = queries + _attn(p["self_attn"], q, q, queries, nh)
    queries = nn.layer_norm(p["norm1"], queries)

    q = queries + query_pe
    k = keys + key_pe
    queries = queries + _attn(p["cross_t2i"], q, k, keys, nh)
    queries = nn.layer_norm(p["norm2"], queries)

    queries = queries + nn.mlp(p["mlp"], queries, act=F.relu)
    queries = nn.layer_norm(p["norm3"], queries)

    q = queries + query_pe
    k = keys + key_pe
    keys = keys + _attn(p["cross_i2t"], k, q, queries, nh)
    keys = nn.layer_norm(p["norm4"], keys)
    return queries, keys


def twoway_transformer_init(g, cfg: MaskDecoderConfig, dtype=torch.float32):
    return {
        "layers": [_twoway_block_init(g, cfg, dtype)
                   for _ in range(cfg.transformer_depth)],
        "final_attn": _attn_init(g, cfg.transformer_dim,
                                 cfg.attention_downsample_rate, dtype),
        "norm_final": nn.layer_norm_init(g, cfg.transformer_dim, dtype),
    }


def twoway_transformer(p, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                       point_embedding: torch.Tensor, nh: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embedding/image_pe: [B, H, W, C]; point_embedding: [B, N, C]."""
    b, h, w, c = image_embedding.shape
    keys = image_embedding.reshape(b, h * w, c)
    key_pe = image_pe.reshape(image_pe.shape[0], h * w, c).expand(keys.shape)
    queries = point_embedding
    for i, layer in enumerate(p["layers"]):
        queries, keys = _twoway_block(layer, queries, keys, point_embedding,
                                      key_pe, nh, skip_first_layer_pe=(i == 0))
    q = queries + point_embedding
    k = keys + key_pe
    queries = queries + _attn(p["final_attn"], q, k, keys, nh)
    queries = nn.layer_norm(p["norm_final"], queries)
    return queries, keys


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

def init(g, cfg: MaskDecoderConfig, dtype=torch.float32):
    d = cfg.transformer_dim
    return {
        "transformer": twoway_transformer_init(g, cfg, dtype),
        "iou_token": nn.embedding_init(g, 1, d, std=1.0, dtype=dtype),
        "mask_tokens": nn.embedding_init(g, cfg.num_mask_tokens, d, std=1.0, dtype=dtype),
        "upscale_conv1": nn.conv_transpose2d_init(g, d, d // 4, (2, 2), dtype=dtype),
        "upscale_ln": nn.layer_norm_init(g, d // 4, dtype),
        "upscale_conv2": nn.conv_transpose2d_init(g, d // 4, d // 8, (2, 2), dtype=dtype),
        "hypernet_mlps": [nn.relu_mlp_stack_init(g, [d, d, d, d // 8], dtype=dtype)
                          for _ in range(cfg.num_mask_tokens)],
        "iou_head": nn.relu_mlp_stack_init(
            g, [d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1)
            + [cfg.num_mask_tokens], dtype=dtype),
    }


def predict_masks(p, cfg: MaskDecoderConfig, image_embeddings: torch.Tensor,
                  image_pe: torch.Tensor, sparse_prompt: torch.Tensor,
                  dense_prompt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embeddings: [1 or B, H, W, C]; sparse_prompt: [B, N, C];
    dense_prompt: [B, H, W, C]. Returns (masks [B, T, 4H, 4W], iou [B, T])."""
    b = sparse_prompt.shape[0]
    out_tokens = torch.cat([p["iou_token"]["w"], p["mask_tokens"]["w"]], dim=0)
    tokens = torch.cat([out_tokens[None].expand(b, *out_tokens.shape),
                        sparse_prompt.to(out_tokens.dtype)], dim=1)

    src = image_embeddings.expand(b, *image_embeddings.shape[1:]) + dense_prompt
    hs, src_out = twoway_transformer(p["transformer"], src, image_pe, tokens,
                                     cfg.transformer_num_heads)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + cfg.num_mask_tokens]

    h, w = src.shape[1], src.shape[2]
    src_maps = src_out.reshape(b, h, w, cfg.transformer_dim)
    up = nn.conv_transpose2d(p["upscale_conv1"], src_maps, stride=(2, 2))
    up = nn.gelu_exact(nn.layer_norm2d(p["upscale_ln"], up))
    up = nn.gelu_exact(nn.conv_transpose2d(p["upscale_conv2"], up, stride=(2, 2)))

    hyper_in = torch.stack(
        [nn.relu_mlp_stack(p["hypernet_mlps"][i], mask_tokens_out[:, i])
         for i in range(cfg.num_mask_tokens)], dim=1)          # [B, T, C/8]
    uh, uw, uc = up.shape[1], up.shape[2], up.shape[3]
    dt = torch.promote_types(hyper_in.dtype, up.dtype)
    masks = torch.einsum("btc,bpc->btp", hyper_in.to(dt),
                         up.reshape(b, uh * uw, uc).to(dt)
                         ).reshape(b, cfg.num_mask_tokens, uh, uw)
    iou_pred = nn.relu_mlp_stack(p["iou_head"], iou_token_out)
    return masks, iou_pred


def apply(p, cfg: MaskDecoderConfig, *, image_embeddings: torch.Tensor,
          image_pe: torch.Tensor, sparse_prompt: torch.Tensor,
          dense_prompt: torch.Tensor, multimask_output: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    masks, iou_pred = predict_masks(p, cfg, image_embeddings, image_pe,
                                    sparse_prompt, dense_prompt)
    sl = slice(1, None) if multimask_output else slice(0, 1)
    return masks[:, sl], iou_pred[:, sl]
