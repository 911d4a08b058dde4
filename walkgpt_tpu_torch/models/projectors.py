"""WalkGPT's projectors (PyTorch counterpart of walkgpt_tpu/models/projectors.py).

  * MSQP (multi-scale QFormer projector): SAM grid tokens -> queries at four
    pooling scales through cross-attention stacks with a sigmoid token gate,
    padded to a square with a learned pad token, projected to the LLM width.
  * CTP (calibrated text projector): LN -> Linear -> GELU -> Linear -> LN, a
    learned text-type vector, L2-normalised and scaled by exp(log_temp).
  * TinyCrossAttn: the one-query cross-attention that pools a [SEG]
    embedding's SAM tokens for the InfoNCE loss (ops/losses.py).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core import nn
from ..core.config import CTPConfig, MSQPConfig
from ..ops.attention import merge_heads, mha, split_heads


def _xattn_block_init(g, d_model: int, mlp_ratio: float, dtype):
    return {
        "q_norm": nn.layer_norm_init(g, d_model, dtype),
        "kv_norm": nn.layer_norm_init(g, d_model, dtype),
        "attn": {name: nn.linear_init(g, d_model, d_model, dtype=dtype)
                 for name in ("q", "k", "v", "out")},
        "ffn": {
            "norm": nn.layer_norm_init(g, d_model, dtype),
            "mlp": nn.mlp_init(g, d_model, int(d_model * mlp_ratio), dtype=dtype),
        },
    }


def _xattn_block(p, queries: torch.Tensor, kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Pre-LN cross-attention + FFN with residuals."""
    q = nn.layer_norm(p["q_norm"], queries)
    k = nn.layer_norm(p["kv_norm"], kv)
    a = p["attn"]
    out = mha(split_heads(nn.linear(a["q"], q), num_heads),
              split_heads(nn.linear(a["k"], k), num_heads),
              split_heads(nn.linear(a["v"], k), num_heads))
    out = queries + nn.linear(a["out"], merge_heads(out))
    h = nn.layer_norm(p["ffn"]["norm"], out)
    return out + nn.mlp(p["ffn"]["mlp"], h, act=nn.gelu_exact)


def _pool_grid(tokens: torch.Tensor, h: int, w: int, scale: int) -> torch.Tensor:
    """Average-pool a [B, H*W, C] token grid by `scale` (VALID windows)."""
    b, _, c = tokens.shape
    hp, wp = h // scale, w // scale
    x = tokens.reshape(b, h, w, c)[:, :hp * scale, :wp * scale]
    x = x.reshape(b, hp, scale, wp, scale, c).sum(dim=(2, 4)) / (scale * scale)
    return x.reshape(b, hp * wp, c)


def msqp_init(g, cfg: MSQPConfig, llm_dim: int, dtype=torch.float32):
    d = cfg.d_proj

    def queries(n):
        return nn.trunc_normal(g, (1, n, d), std=0.02, dtype=dtype) if n else None

    def stack(n):
        return [_xattn_block_init(g, d, cfg.mlp_ratio, dtype)
                for _ in range(cfg.num_layers)] if n else None

    return {
        "sam_to_proj": nn.linear_init(g, cfg.sam_dim, d, dtype=dtype),
        "q_x1": queries(cfg.queries_x1),
        "q_x2": queries(cfg.queries_x2),
        "q_x4": queries(cfg.queries_x4),
        "q_global": queries(cfg.queries_global),
        "cross_x1": stack(cfg.queries_x1),
        "cross_x2": stack(cfg.queries_x2),
        "cross_x4": stack(cfg.queries_x4),
        "cross_glb": stack(cfg.queries_global),
        "gate": {
            "norm": nn.layer_norm_init(g, d, dtype),
            "fc1": nn.linear_init(g, d, cfg.gate_hidden, dtype=dtype),
            "fc2": nn.linear_init(g, cfg.gate_hidden, 1, dtype=dtype),
        },
        "pad_token": nn.trunc_normal(g, (1, 1, d), std=0.02, dtype=dtype),
        "to_llama": nn.linear_init(g, d, llm_dim, dtype=dtype),
    }


def _gate(p, kv: torch.Tensor) -> torch.Tensor:
    """Segmentation-aware sigmoid token gate."""
    h = nn.layer_norm(p["norm"], kv)
    logits = nn.linear(p["fc2"], nn.gelu_exact(nn.linear(p["fc1"], h)))
    return kv * torch.sigmoid(logits)


def msqp_apply(params, cfg: MSQPConfig, sam_tokens: torch.Tensor) -> torch.Tensor:
    """sam_tokens: [B, L, sam_dim] (L a perfect square) -> [B, s*s, llm_dim]."""
    b, l, _ = sam_tokens.shape
    h = w = math.isqrt(l)
    if h * w != l:
        raise ValueError(f"token length {l} is not a perfect square")
    feats = nn.linear(params["sam_to_proj"], sam_tokens)

    scales = []
    if cfg.queries_x1:
        scales.append(("q_x1", "cross_x1", feats))
    if cfg.queries_x2:
        scales.append(("q_x2", "cross_x2", _pool_grid(feats, h, w, 2)))
    if cfg.queries_x4:
        scales.append(("q_x4", "cross_x4", _pool_grid(feats, h, w, 4)))
    if cfg.queries_global:
        scales.append(("q_global", "cross_glb", feats.mean(dim=1, keepdim=True)))

    outs = []
    for q_name, stack_name, kv in scales:
        kv = _gate(params["gate"], kv)
        q = params[q_name].expand(b, *params[q_name].shape[1:]).to(kv.dtype)
        for blk in params[stack_name]:
            q = _xattn_block(blk, q, kv, cfg.num_heads)
        outs.append(q)

    vis = torch.cat(outs, dim=1)                             # [B, num_queries, d]
    pad = cfg.num_tokens - cfg.num_queries
    if pad < 0:
        raise ValueError("target_square_side too small")
    if pad > 0:
        pad_tok = params["pad_token"].expand(b, pad, vis.shape[-1]).to(vis.dtype)
        vis = torch.cat([vis, pad_tok], dim=1)               # [B, s*s, d]
    return nn.linear(params["to_llama"], vis)


def ctp_init(g, cfg: CTPConfig, in_dim: int, dtype=torch.float32):
    mid = max(cfg.out_dim * cfg.widen, cfg.out_dim)
    return {
        "norm_in": nn.layer_norm_init(g, in_dim, dtype),
        "fc1": nn.linear_init(g, in_dim, mid, dtype=dtype),
        # the upstream projector initialises the second linear orthogonally, gain 0.5
        "fc2": nn.linear_init(g, mid, cfg.out_dim, init="orthogonal", std=0.5, dtype=dtype),
        "norm_out": nn.layer_norm_init(g, cfg.out_dim, dtype),
        "text_type": torch.zeros((cfg.out_dim,), dtype=dtype, device=g.device),
        "log_temp": torch.zeros((1,), dtype=dtype, device=g.device),
    }


def ctp_apply(params, x: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """[..., in_dim] -> [..., out_dim], L2-normalized (fp32) * exp(log_temp)."""
    y = nn.layer_norm(params["norm_in"], x)
    y = nn.gelu_exact(nn.linear(params["fc1"], y))
    y = nn.linear(params["fc2"], y)
    y = nn.layer_norm(params["norm_out"], y)
    y = y + params["text_type"].to(y.dtype)
    norm = torch.linalg.vector_norm(y.float(), dim=-1, keepdim=True).clamp_min(eps)
    scale = torch.exp(params["log_temp"].float())[0]
    return (y.float() / norm * scale).to(x.dtype)


def tiny_xattn_init(g, d: int = 256, dtype=torch.float32):
    return {name: nn.linear_init(g, d, d, bias=False, dtype=dtype)
            for name in ("wq", "wk", "wv", "out")}


def tiny_xattn_apply(params, q_vec: torch.Tensor, kv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_vec: [M, d]; kv: [M, N, d] -> (pooled [M, d], attention [M, N]).
    Logits in fp32, divided by sqrt(d); the probabilities cast to v's dtype
    for the value product."""
    d = kv.shape[-1]
    q = nn.linear(params["wq"], q_vec)[:, None, :]
    k = nn.linear(params["wk"], kv)
    v = nn.linear(params["wv"], kv)
    logits = torch.einsum("mqd,mnd->mqn", q.float(), k.float()) / math.sqrt(d)
    attn = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("mqn,mnd->mqd", attn.to(v.dtype), v)[:, 0]
    return nn.linear(params["out"], ctx), attn[:, 0]
