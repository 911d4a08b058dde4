"""SAM ViT image encoder (PyTorch counterpart of walkgpt_tpu/models/sam_encoder.py).

NHWC activations end to end; windows are folded into the batch axis; the
rel-pos bias enters either through the attention kernels (use_flash: K2 for
the windowed blocks over the packed qkv layout, K3 for the global blocks) or
as an additive bias to the plain einsum attention. The neck runs in fp32.
Parameters use the `blocks` layout (one dict per block).
"""
from __future__ import annotations

import torch

from ..core import nn
from ..core.config import SAMEncoderConfig
from ..ops.attention import (decomposed_rel_pos_bias, get_rel_pos, merge_heads, mha,
                             split_heads, window_partition, window_unpartition)
from ..ops.flash_attention import sam_flash_attention, sam_window_attention_packed


def init(g: torch.Generator, cfg: SAMEncoderConfig, dtype=torch.float32):
    grid = cfg.grid
    params = {
        "patch_embed": nn.conv2d_init(g, 3, cfg.embed_dim,
                                      (cfg.patch_size, cfg.patch_size), dtype=dtype),
        "pos_embed": torch.zeros((1, grid, grid, cfg.embed_dim), dtype=dtype,
                                 device=g.device),
        "blocks": [],
        "neck": {
            "conv1": nn.conv2d_init(g, cfg.embed_dim, cfg.out_chans, (1, 1),
                                    bias=False, dtype=dtype),
            "ln1": nn.layer_norm_init(g, cfg.out_chans, dtype),
            "conv2": nn.conv2d_init(g, cfg.out_chans, cfg.out_chans, (3, 3),
                                    bias=False, dtype=dtype),
            "ln2": nn.layer_norm_init(g, cfg.out_chans, dtype),
        },
    }
    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        size = grid if i in cfg.global_attn_indexes else cfg.window_size
        blk = {
            "ln1": nn.layer_norm_init(g, cfg.embed_dim, dtype),
            "qkv": nn.linear_init(g, cfg.embed_dim, 3 * cfg.embed_dim, dtype=dtype),
            "proj": nn.linear_init(g, cfg.embed_dim, cfg.embed_dim, dtype=dtype),
            "ln2": nn.layer_norm_init(g, cfg.embed_dim, dtype),
            "mlp": nn.mlp_init(g, cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                               dtype=dtype),
        }
        if cfg.use_rel_pos:
            blk["rel_pos_h"] = torch.zeros((2 * size - 1, head_dim), dtype=dtype,
                                           device=g.device)
            blk["rel_pos_w"] = torch.zeros((2 * size - 1, head_dim), dtype=dtype,
                                           device=g.device)
        params["blocks"].append(blk)
    return params


def _rel_projections(q, rel_pos_h, rel_pos_w, h, w):
    """Per-axis rel-pos projections ([B,Hd,N,kh], [B,Hd,N,kw]) in q's dtype."""
    rh = get_rel_pos(h, h, rel_pos_h).to(q.dtype)
    rw = get_rel_pos(w, w, rel_pos_w).to(q.dtype)
    b, nh, _, d = q.shape
    r_q = q.reshape(b, nh, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    return rel_h.reshape(b, nh, h * w, h), rel_w.reshape(b, nh, h * w, w)


def _rel_projections_packed(q_flat, rel_pos_h, rel_pos_w, ws, num_heads):
    """Rel-pos projections from the unsplit q ([BW, T, H*D]) into K2's packed
    layout [BW, T, 2*H*ws]: lanes [h*ws:(h+1)*ws] = rel_h of head h,
    [(H+h)*ws:...] = rel_w."""
    rh = get_rel_pos(ws, ws, rel_pos_h).to(q_flat.dtype)      # [ws, ws, D]
    rw = get_rel_pos(ws, ws, rel_pos_w).to(q_flat.dtype)
    bw, t, c = q_flat.shape
    d = c // num_heads
    r_q = q_flat.reshape(bw, ws, ws, num_heads, d)
    rel_h = torch.einsum("bxynd,xkd->bxynk", r_q, rh)          # [bw,x,y,H,ws]
    rel_w = torch.einsum("bxynd,ykd->bxynk", r_q, rw)
    return torch.cat([rel_h.reshape(bw, t, num_heads * ws),
                      rel_w.reshape(bw, t, num_heads * ws)], dim=-1)


def _attention(p, x: torch.Tensor, num_heads: int, use_rel_pos: bool,
               use_flash: bool, windowed: bool = False) -> torch.Tensor:
    """x: [B, H, W, C] (B may include folded windows)."""
    b, h, w, c = x.shape
    qkv = nn.linear(p["qkv"], x.reshape(b, h * w, c))
    if use_flash and use_rel_pos and windowed:
        # K2 over the packed layout: qkv stays unsplit, merged heads come back
        rel = _rel_projections_packed(qkv[:, :, :c], p["rel_pos_h"], p["rel_pos_w"],
                                      h, num_heads)
        out = sam_window_attention_packed(qkv, rel, num_heads, c // num_heads, h)
        return nn.linear(p["proj"], out).reshape(b, h, w, c)
    q, k, v = (split_heads(t, num_heads) for t in qkv.split(c, dim=-1))
    if use_flash and use_rel_pos:
        rel_h, rel_w = _rel_projections(q, p["rel_pos_h"], p["rel_pos_w"], h, w)
        out = sam_flash_attention(q, k, v, rel_h.to(q.dtype), rel_w.to(q.dtype), (h, w))
    else:
        bias = None
        if use_rel_pos:
            bias = decomposed_rel_pos_bias(q, p["rel_pos_h"], p["rel_pos_w"],
                                           (h, w), (h, w))
        out = mha(q, k, v, bias=bias)
    return nn.linear(p["proj"], merge_heads(out)).reshape(b, h, w, c)


def _block(p, x: torch.Tensor, cfg: SAMEncoderConfig, window: int,
           use_flash: bool, fast_gelu: bool = False) -> torch.Tensor:
    shortcut = x
    x = nn.layer_norm(p["ln1"], x)
    if window > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
        x = _attention(p, x, cfg.num_heads, cfg.use_rel_pos, use_flash, windowed=True)
        x = window_unpartition(x, window, pad_hw, (h, w))
    else:
        x = _attention(p, x, cfg.num_heads, cfg.use_rel_pos, use_flash)
    x = shortcut + x
    act = nn.gelu_tanh if fast_gelu else nn.gelu_exact
    return x + nn.mlp(p["mlp"], nn.layer_norm(p["ln2"], x), act=act)


def apply(params, cfg: SAMEncoderConfig, images: torch.Tensor, *,
          use_flash: bool = False, fast_gelu: bool = False) -> torch.Tensor:
    """images: [B, img, img, 3] NHWC (normalized, padded). Returns
    [B, grid, grid, out_chans] NHWC feature maps."""
    if "blocks" not in params:
        raise NotImplementedError("only the `blocks` parameter layout is ported; "
                                  "the stacked `block_runs` layout is not")
    x = nn.conv2d(params["patch_embed"], images,
                  stride=(cfg.patch_size, cfg.patch_size), padding="VALID")
    x = x + params["pos_embed"].to(x.dtype)
    for i, blk in enumerate(params["blocks"]):
        window = 0 if i in cfg.global_attn_indexes else cfg.window_size
        x = _block(blk, x, cfg, window, use_flash, fast_gelu)
    # neck in fp32 (the upstream encoder's overflow guard)
    n = params["neck"]
    y = x.float()
    y = nn.conv2d({k: v.float() for k, v in n["conv1"].items()}, y, padding="VALID")
    y = nn.layer_norm2d(n["ln1"], y)
    y = nn.conv2d({k: v.float() for k, v in n["conv2"].items()}, y, padding="SAME")
    y = nn.layer_norm2d(n["ln2"], y)
    return y.to(x.dtype)
