"""SAM composition: encoder + prompt encoder + mask decoder (PyTorch
counterpart of walkgpt_tpu/models/sam.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import (MaskDecoderConfig, PromptEncoderConfig, SAMEncoderConfig,
                           SAM_VIT_H)
from . import sam_decoder, sam_encoder, sam_prompt

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    encoder: SAMEncoderConfig = SAM_VIT_H
    prompt: PromptEncoderConfig = PromptEncoderConfig()
    decoder: MaskDecoderConfig = MaskDecoderConfig()
    mask_threshold: float = 0.0


def init(g: torch.Generator, cfg: SamConfig, dtype=torch.float32):
    return {
        "image_encoder": sam_encoder.init(g, cfg.encoder, dtype),
        "prompt_encoder": sam_prompt.init(g, cfg.prompt, dtype),
        "mask_decoder": sam_decoder.init(g, cfg.decoder, dtype),
    }


def encode_image(params, cfg: SamConfig, images: torch.Tensor, *,
                 use_flash: bool = False, fast_gelu: bool = False) -> torch.Tensor:
    """[B, S, S, 3] -> [B, grid, grid, 256] NHWC."""
    return sam_encoder.apply(params["image_encoder"], cfg.encoder, images,
                             use_flash=use_flash, fast_gelu=fast_gelu)


def decode_masks(params, cfg: SamConfig, image_embeddings: torch.Tensor, *,
                 text_embeds: Optional[torch.Tensor] = None,
                 multimask_output: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-encode + mask-decode. Returns (low_res_masks [B,T,4g,4g], iou)."""
    sparse, dense = sam_prompt.apply(params["prompt_encoder"], cfg.prompt,
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
