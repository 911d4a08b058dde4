"""CLIP ViT vision tower (PyTorch counterpart of
`walkgpt_tpu/models/clip_vit.py`).

Functional rewrite of the reference tower
(model/llava_walkgpt/model/multimodal_encoder/clip_encoder.py:6-125 and the
padding-mask variant custom_clip.py:27-152):
  * position embeddings trained at 224px are bilinearly resized to the 448px
    patch grid at init/load time (clip_encoder.py:38-55);
  * an optional token-level attention mask supports the padded-image path
    (class token always attended);
  * feature selection returns hidden_states[select_layer][:, 1:] plus the aux
    level hidden_states[aux_layer] (clip_encoder.py:61-69).

CLIP uses quick-GELU (x * sigmoid(1.702 x)) and pre-LN blocks. Attention is
the plain `ops/attention.mha`, as the JAX package computes it outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core import nn
from ..core.config import CLIPVisionConfig
from ..ops.attention import merge_heads, mha, split_heads
from ..ops.resize import bilinear_resize


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def init(g: torch.Generator, cfg: CLIPVisionConfig, dtype=torch.float32):
    h = cfg.hidden_size
    grid = cfg.grid
    params = {
        "patch_embed": nn.conv2d_init(g, 3, h, (cfg.patch_size, cfg.patch_size),
                                      bias=False, dtype=dtype),
        "class_embed": nn.trunc_normal(g, (h,), std=0.02, dtype=dtype),
        # stored at the *target* grid; converters resize the 224px pretrain one
        "pos_embed": nn.trunc_normal(g, (1 + grid * grid, h), std=0.02, dtype=dtype),
        "pre_ln": nn.layer_norm_init(g, h, dtype),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": nn.layer_norm_init(g, h, dtype),
            "attn": {k: nn.linear_init(g, h, h, dtype=dtype) for k in ("q", "k", "v", "out")},
            "ln2": nn.layer_norm_init(g, h, dtype),
            "mlp": nn.mlp_init(g, h, cfg.mlp_dim, dtype=dtype),
        })
    return params


def resize_pos_embed(pos_embed: torch.Tensor, src_grid: int, dst_grid: int) -> torch.Tensor:
    """[1+s*s, C] -> [1+d*d, C]: class position kept, patch grid bilinear-resized
    (clip_encoder.py:38-55 semantics)."""
    if src_grid == dst_grid:
        return pos_embed
    cls, patch = pos_embed[:1], pos_embed[1:]
    c = patch.shape[-1]
    grid = bilinear_resize(patch.reshape(src_grid, src_grid, c)[None], (dst_grid, dst_grid))[0]
    return torch.cat([cls, grid.reshape(dst_grid * dst_grid, c)], dim=0)


def apply(params, cfg: CLIPVisionConfig, images: torch.Tensor, *,
          attention_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """images: [B, S, S, 3] NHWC. attention_mask: optional [B, 1+P] bool over
    [class]+patch tokens. Returns all hidden states (embeddings + per layer),
    so callers select cfg.select_layer / cfg.aux_layer."""
    b = images.shape[0]
    x = nn.conv2d(params["patch_embed"], images, stride=(cfg.patch_size, cfg.patch_size),
                  padding="VALID")
    x = x.reshape(b, -1, cfg.hidden_size)
    cls = params["class_embed"][None, None].expand(b, 1, cfg.hidden_size).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][None].to(x.dtype)
    x = nn.layer_norm(params["pre_ln"], x, eps=cfg.ln_eps)

    mask = None if attention_mask is None else attention_mask[:, None, None, :]  # keys masked

    hidden_states = [x]
    for layer in params["layers"]:
        h = nn.layer_norm(layer["ln1"], x, eps=cfg.ln_eps)
        a = layer["attn"]
        att = mha(split_heads(nn.linear(a["q"], h), cfg.num_heads),
                  split_heads(nn.linear(a["k"], h), cfg.num_heads),
                  split_heads(nn.linear(a["v"], h), cfg.num_heads), mask=mask)
        x = x + nn.linear(a["out"], merge_heads(att))
        h = nn.layer_norm(layer["ln2"], x, eps=cfg.ln_eps)
        x = x + nn.mlp(layer["mlp"], h, act=quick_gelu)
        hidden_states.append(x)
    return hidden_states


def select_features(hidden_states: List[torch.Tensor], cfg: CLIPVisionConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(select-layer patch features [B, P, C], aux-layer features)."""
    return hidden_states[cfg.select_layer][:, 1:], hidden_states[cfg.aux_layer][:, 1:]
