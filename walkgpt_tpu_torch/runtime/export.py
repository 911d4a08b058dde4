"""Portable mask-decoder export (PyTorch counterpart of
walkgpt_tpu/runtime/export.py, the reference's ONNX export wrapper): the
prompt encoder + mask decoder graph for text prompts is traced with
torch.export and written with torch.export.save, so a serving runtime can
decode masks against precomputed image embeddings without the model's
Python code. The parameters are buffers of the exported program, on the
device they lie on when exported.
"""
from __future__ import annotations

import os

import torch

from ..core.tree import leaves_with_path, map_with_path
from ..models import sam as sam_mod


class _MaskDecoder(torch.nn.Module):
    """sam.decode_masks(text_embeds=..., multimask_output=False) with the
    parameter tree's tensors registered as buffers p0, p1, ... in the
    tree's leaf order."""

    def __init__(self, params, cfg: sam_mod.SamConfig):
        super().__init__()
        self.cfg = cfg
        self._tree = params
        self._names = {}
        for i, (path, leaf) in enumerate(leaves_with_path(params).items()):
            if isinstance(leaf, torch.Tensor):
                self.register_buffer(f"p{i}", leaf)
                self._names[path] = f"p{i}"

    def forward(self, image_embeddings, text_embeds):
        params = map_with_path(
            lambda path, x: getattr(self, self._names[path]) if path in self._names else x,
            self._tree)
        return sam_mod.decode_masks(params, self.cfg, image_embeddings,
                                    text_embeds=text_embeds, multimask_output=False)


def export_mask_decoder(params, cfg: sam_mod.SamConfig, path: str, *,
                        max_prompts: int = 16, dtype=torch.float32) -> str:
    """Write decode_masks(text_embeds) as a torch.export program.

    Input signature (static shapes, like the ONNX wrapper's fixed examples):
      image_embeddings [1, g, g, C], text_embeds [max_prompts, 1, C]
    Output: (low_res_masks [max_prompts, 1, 4g, 4g], iou [max_prompts, 1]).
    params are a SAM tree (image_encoder, prompt_encoder, mask_decoder); the
    program runs on their device."""
    g = cfg.prompt.image_embedding_size[0]
    c = cfg.prompt.embed_dim
    sub = {k: params[k] for k in ("prompt_encoder", "mask_decoder")}
    device = params["mask_decoder"]["iou_token"]["w"].device
    example = (torch.zeros((1, g, g, c), dtype=dtype, device=device),
               torch.zeros((max_prompts, 1, c), dtype=dtype, device=device))
    with torch.no_grad():
        program = torch.export.export(_MaskDecoder(sub, cfg), example)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path: str):
    """Read an exported program; returns a callable (image_embeddings,
    text_embeds) -> (low_res_masks, iou)."""
    return torch.export.load(path).module()
