"""SAMVisionTower: the SAM encoder as a CLIP-like vision tower, giving
flattened tokens, the spatial feature maps and the grid (PyTorch counterpart
of walkgpt_tpu/models/sam_tower.py). With use_flash the encoder runs K2 and
K3 on the GPU, their plain versions on the CPU."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import SAMEncoderConfig
from . import sam_encoder


class SAMTowerOutput(NamedTuple):
    tokens: torch.Tensor       # [B, g*g, C]
    spatial: torch.Tensor      # [B, g, g, C]
    grid: Tuple[int, int]


class SAMVisionTower:
    def __init__(self, params, cfg: SAMEncoderConfig, *, use_flash: bool = False):
        self.params = params
        self.cfg = cfg
        self.use_flash = use_flash
        self.hidden_size = cfg.out_chans

    @property
    def num_patches(self) -> int:
        return self.cfg.grid ** 2

    def __call__(self, images: torch.Tensor) -> SAMTowerOutput:
        feats = sam_encoder.apply(self.params, self.cfg, images, use_flash=self.use_flash)
        b, g1, g2, c = feats.shape
        return SAMTowerOutput(tokens=feats.reshape(b, g1 * g2, c), spatial=feats,
                              grid=(g1, g2))
