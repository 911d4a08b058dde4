"""SAM composition: encoder + prompt encoder + mask decoder, with preprocess
and postprocess (PyTorch counterpart of walkgpt_tpu/models/sam.py) and the
ViT-H / L / B registry."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import (MaskDecoderConfig, PromptEncoderConfig, SAMEncoderConfig,
                           SAM_VIT_B, SAM_VIT_H, SAM_VIT_L)
from ..ops.resize import bilinear_resize
from . import sam_decoder, sam_encoder, sam_prompt

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    encoder: SAMEncoderConfig = SAM_VIT_H
    prompt: PromptEncoderConfig = PromptEncoderConfig()
    decoder: MaskDecoderConfig = MaskDecoderConfig()
    mask_threshold: float = 0.0

    @classmethod
    def vit_h(cls): return cls(encoder=SAM_VIT_H)
    @classmethod
    def vit_l(cls): return cls(encoder=SAM_VIT_L)
    @classmethod
    def vit_b(cls): return cls(encoder=SAM_VIT_B)

    @classmethod
    def for_encoder(cls, enc: SAMEncoderConfig, **kw):
        """A prompt encoder and mask decoder sized to `enc` (its grid, input
        size and output channels)."""
        grid = enc.grid
        return cls(encoder=enc,
                   prompt=PromptEncoderConfig(
                       embed_dim=enc.out_chans,
                       image_embedding_size=(grid, grid),
                       input_image_size=(enc.img_size, enc.img_size),
                       mask_in_chans=max(4, enc.out_chans // 16)),
                   decoder=MaskDecoderConfig(
                       transformer_dim=enc.out_chans,
                       transformer_mlp_dim=max(64, enc.out_chans * 8),
                       transformer_num_heads=min(8, enc.out_chans // 16)),
                   **kw)


def init(g: torch.Generator, cfg: SamConfig, dtype=torch.float32):
    return {
        "image_encoder": sam_encoder.init(g, cfg.encoder, dtype),
        "prompt_encoder": sam_prompt.init(g, cfg.prompt, dtype),
        "mask_decoder": sam_decoder.init(g, cfg.decoder, dtype),
    }


def encode_image(params, cfg: SamConfig, images: torch.Tensor, *,
                 use_flash: bool = False, fast_windowed: bool = False,
                 fast_gelu: bool = False, tp=None) -> torch.Tensor:
    """[B, S, S, 3] -> [B, grid, grid, 256] NHWC (tp: a rank of the GSPMD
    leg, models/sam_encoder.py)."""
    return sam_encoder.apply(params["image_encoder"], cfg.encoder, images,
                             use_flash=use_flash, fast_windowed=fast_windowed,
                             fast_gelu=fast_gelu, tp=tp)


def decode_masks(params, cfg: SamConfig, image_embeddings: torch.Tensor, *,
                 text_embeds: Optional[torch.Tensor] = None,
                 points=None, boxes=None, masks=None,
                 multimask_output: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-encode + mask-decode. points = (coords [B, N, 2], labels
    [B, N]) and boxes [B, 4] in the input frame, masks [B, 4g, 4g, 1] low-res
    logits. Returns (low_res_masks [B,T,4g,4g], iou)."""
    sparse, dense = sam_prompt.apply(params["prompt_encoder"], cfg.prompt,
                                     points=points, boxes=boxes, masks=masks,
                                     text_embeds=text_embeds)
    image_pe = sam_prompt.get_dense_pe(params["prompt_encoder"], cfg.prompt)
    return sam_decoder.apply(params["mask_decoder"], cfg.decoder,
                             image_embeddings=image_embeddings, image_pe=image_pe,
                             sparse_prompt=sparse, dense_prompt=dense,
                             multimask_output=multimask_output)


def preprocess(images: torch.Tensor, img_size: int) -> torch.Tensor:
    """Upstream SAM normalize + bottom/right zero pad, NHWC."""
    mean = torch.tensor(SAM_PIXEL_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(SAM_PIXEL_STD, dtype=torch.float32, device=images.device)
    x = (images - mean) / std
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))


def postprocess_masks(masks: torch.Tensor, *, img_size: int,
                      input_size: Tuple[int, int],
                      original_size: Tuple[int, int]) -> torch.Tensor:
    """Upscale low-res masks to img_size, crop the padding, resize to the
    original size. masks: [B, T, h, w] -> [B, T, *original_size]."""
    b, t = masks.shape[:2]
    x = masks.reshape(b * t, *masks.shape[2:])[..., None]       # [BT, h, w, 1]
    x = bilinear_resize(x, (img_size, img_size))
    x = x[:, :input_size[0], :input_size[1]]
    x = bilinear_resize(x, tuple(original_size))
    return x[..., 0].reshape(b, t, *original_size)
