"""Transformer LLM decoder (PyTorch counterpart of walkgpt_tpu/models/llm.py).

The rope family (LLaMA; StableLM's partial rope and GQA) with dense or
quantized weights (W8A8 "a8", weight-only int8, packed int4: fused "qkv4" /
"qkv8" projections, packed MLPs and lm_head; ops/quant.py, ops/int4.py).
Inputs are embeddings, not ids (the multimodal splice happens in
models/walkgpt.py). Full-sequence forwards take a `flash_fn` (the K1 kernel
wrapper) for causal attention with a key mask.

Two KV caches: the heads layout [layers, B, n_kv, L, D] in the activation
dtype, read by the plain einsum attention, and the flat quantized layout
(int8 rows [layers, B, L, n_kv*D] or packed int4 rows [.., n_kv*D/2], bf16
scales [layers, B, n_kv, L]) read by the K4 kernel. ALiBi (MPT), LoRA, the
heads-layout quantized cache and the flat bf16 cache of the JAX package are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import nn
from ..core.config import LLMConfig
from ..ops import int4
from ..ops.attention import merge_heads, mha, split_heads
from ..ops.flash_attention import decode_attention_q

Params = Dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(g, cfg: LLMConfig, dtype):
    return (nn.rms_norm_init(g, cfg.hidden_size, dtype) if cfg.norm == "rmsnorm"
            else nn.layer_norm_init(g, cfg.hidden_size, dtype))


def init_layer(g, cfg: LLMConfig, dtype=torch.float32) -> Params:
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    hs = cfg.hidden_size
    layer = {
        "input_norm": _norm_init(g, cfg, dtype),
        "attn": {
            "q": nn.linear_init(g, hs, hs, bias=cfg.qkv_bias, dtype=dtype),
            "k": nn.linear_init(g, hs, kv_dim, bias=cfg.qkv_bias, dtype=dtype),
            "v": nn.linear_init(g, hs, kv_dim, bias=cfg.qkv_bias, dtype=dtype),
            "o": nn.linear_init(g, hs, hs, bias=cfg.qkv_bias, dtype=dtype),
        },
        "post_norm": _norm_init(g, cfg, dtype),
    }
    if cfg.act == "silu":
        layer["mlp"] = {
            "gate": nn.linear_init(g, hs, cfg.intermediate_size, bias=cfg.mlp_bias, dtype=dtype),
            "up": nn.linear_init(g, hs, cfg.intermediate_size, bias=cfg.mlp_bias, dtype=dtype),
            "down": nn.linear_init(g, cfg.intermediate_size, hs, bias=cfg.mlp_bias, dtype=dtype),
        }
    else:
        layer["mlp"] = {
            "fc1": nn.linear_init(g, hs, cfg.intermediate_size, dtype=dtype),
            "fc2": nn.linear_init(g, cfg.intermediate_size, hs, dtype=dtype),
        }
    return layer


def init(g, cfg: LLMConfig, dtype=torch.float32) -> Params:
    params = {
        "embed_tokens": nn.embedding_init(g, cfg.vocab_size, cfg.hidden_size, dtype=dtype),
        "layers": [init_layer(g, cfg, dtype) for _ in range(cfg.num_layers)],
        "final_norm": _norm_init(g, cfg, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.linear_init(g, cfg.hidden_size, cfg.vocab_size,
                                           bias=False, dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope_tables(cfg: LLMConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the rotary dims. positions: [B, T] int.
    Returns cos, sin: [B, T, rot_dim/2] fp32."""
    rot_dim = int(cfg.head_dim * cfg.rope_pct)
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=positions.device) / rot_dim
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x: [B, H, T, D]; HF LLaMA rotate-half convention on the first rot_dim dims."""
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    half = rot_dim // 2
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    cos = cos[:, None].to(x.dtype)        # [B, 1, T, rot/2]
    sin = sin[:, None].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot_dim < x.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _check_supported(cfg: LLMConfig):
    if cfg.pos_emb != "rope":
        raise NotImplementedError(f"pos_emb={cfg.pos_emb!r} is not ported yet (rope only)")


def _norm(p, x, cfg: LLMConfig):
    if cfg.norm == "rmsnorm":
        return nn.rms_norm(p, x, eps=cfg.norm_eps)
    return nn.layer_norm(p, x, eps=cfg.norm_eps)


def _mlp(p, x, cfg: LLMConfig):
    """Packed int4 MLPs take K6 on decode rows; W8A8 MLPs take K7 on decode
    rows (fused_mlp_int8 returns None for longer inputs); the rest the
    per-projection products."""
    if int4.mlp_is_int4(p):
        return int4.mlp_int4(p, x, cfg.act)
    if int4.mlp_is_w8a8(p):
        y = int4.fused_mlp_int8(p, x, cfg.act)
        if y is not None:
            return y
    if cfg.act == "silu":
        return nn.linear(p["down"], F.silu(nn.linear(p["gate"], x)) * nn.linear(p["up"], x))
    return nn.linear(p["fc2"], nn.gelu_exact(nn.linear(p["fc1"], x)))


def _qkv_proj(p, x: torch.Tensor, cfg: LLMConfig):
    """q/k/v projections: one packed int4 product (K5 on decode rows) for
    "qkv4", one W8A8 product for "qkv8", else three."""
    if "qkv4" in p or "qkv8" in p:
        qkv = (int4.int4_matmul_pallas(x, p["qkv4"]["w_p4"], p["qkv4"]["w_scale"])
               if "qkv4" in p else nn.linear(p["qkv8"], x))
        hq = cfg.num_heads * cfg.head_dim
        kvd = cfg.num_kv_heads * cfg.head_dim
        return qkv[..., :hq], qkv[..., hq:hq + kvd], qkv[..., hq + kvd:]
    return nn.linear(p["q"], x), nn.linear(p["k"], x), nn.linear(p["v"], x)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, n_kv, T, D] -> [B, n_kv*n_rep, T, D] (GQA repeat)."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def _qkv_rope(p, cfg: LLMConfig, x: torch.Tensor, cos, sin):
    qp, kp, vp = _qkv_proj(p, x, cfg)
    q = split_heads(qp, cfg.num_heads)
    k = split_heads(kp, cfg.num_kv_heads)
    v = split_heads(vp, cfg.num_kv_heads)
    rot_dim = int(cfg.head_dim * cfg.rope_pct)
    return apply_rope(q, cos, sin, rot_dim), apply_rope(k, cos, sin, rot_dim), v


def _attention(p, cfg: LLMConfig, x: torch.Tensor, *, cos, sin,
               mask: torch.Tensor, flash_fn=None,
               key_valid: Optional[torch.Tensor] = None):
    """Full-sequence self-attention. Returns (output, (k, v)) with the new
    keys/values [B, n_kv, T, D] (pre-repeat, post-rope) for the cache.
    flash_fn(q, k, v, key_valid) implements causal attention (K1)."""
    q, k, v = _qkv_rope(p, cfg, x, cos, sin)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if flash_fn is not None:
        out = flash_fn(q, kr, vr, key_valid)
    else:
        out = mha(q, kr, vr, mask=mask)
    return nn.linear(p["o"], merge_heads(out)), (k, v)


def lm_logits(params: Params, cfg: LLMConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ params["embed_tokens"]["w"].T
    head = params["lm_head"]
    if "w_p4" in head and "b" not in head:
        # K5 on decode rows; the packed head may be zero-padded to a
        # multiple of 128 columns: slice back to the vocabulary
        logits = int4.int4_matmul_pallas(hidden, head["w_p4"], head["w_scale"])
        return logits[..., :cfg.vocab_size]
    return nn.linear(head, hidden)


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return nn.embed(params["embed_tokens"], ids)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, dtype=torch.float32,
                  device=None, quant: str = "", layout: str = "heads") -> Params:
    """Zeros. layout="heads": {"k", "v"} [layers, B, n_kv, max_len, D] in
    dtype. layout="flat" with quant "int8" or "int4": values [layers, B,
    max_len, n_kv*D] int8 (int4: [.., n_kv*D/2] packed in global halves) and
    scales [layers, B, n_kv, max_len] bf16."""
    if layout == "flat":
        if quant not in ("int8", "int4"):
            raise NotImplementedError("only the quantized flat caches are ported "
                                      f"(quant 'int8' or 'int4', got {quant!r})")
        kd = cfg.num_kv_heads * cfg.head_dim
        shape = (cfg.num_layers, batch, max_len, kd // 2 if quant == "int4" else kd)
        sshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device)}
    if quant:
        raise NotImplementedError("the heads-layout quantized cache is not ported yet")
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_is_flat(kv_cache: Params) -> bool:
    return kv_cache["k"].ndim == 4


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], bf16 scale [...]): symmetric per row, 127
    levels; the scale is rounded to bf16 first and the division is by the
    rounded scale, so the stored pair is self-consistent."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _quant_pack4_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n_kv, D] -> (packed int8 [..., n_kv*D/2], bf16 scale [...,
    n_kv]): per (row, kv head) int4 (7 levels) divided by the rounded bf16
    scale, packed in GLOBAL halves of the flattened row: byte j holds flat
    dims j (low nibble) and j + n_kv*D/2 (high nibble)."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 7.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()), -7, 7).int()
    kd = x.shape[-2] * x.shape[-1]
    q = q.reshape(*x.shape[:-2], kd)
    packed = ((q[..., :kd // 2] & 0xF) | ((q[..., kd // 2:] & 0xF) << 4))
    return packed.to(torch.uint8).view(torch.int8), scale[..., 0]


def _quant_flat(kv_cache: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n_kv, D] -> the cache's row format: (values [..., width],
    scales [..., n_kv])."""
    n_kv, d = x.shape[-2:]
    if kv_cache["k"].shape[-1] == n_kv * d // 2:
        return _quant_pack4_flat(x)
    q, s = _quant_rows(x)
    return q.reshape(*x.shape[:-2], n_kv * d), s


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor, *,
            attention_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[Params] = None,
            flash_fn=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence (prefill) forward.

    inputs_embeds: [B, T, H]; attention_mask: [B, T] bool (True = real token).
    Positions default to cumsum(mask) - 1 per row. kv_cache, when given, is
    written IN PLACE at slots [0, T) of every layer (the port's caches are
    mutable buffers). Returns (final-norm hidden states [B, T, H], kv_cache).
    """
    _check_supported(cfg)
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        if attention_mask is not None:
            positions = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
        else:
            positions = torch.arange(t, device=dev)[None].expand(b, t)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :]
    cos, sin = rope_tables(cfg, positions)

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        h, (k_new, v_new) = _attention(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg),
                                       cos=cos, sin=sin, mask=mask, flash_fn=flash_fn,
                                       key_valid=attention_mask)
        x = x + h
        x = x + _mlp(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg)
        if kv_cache is not None and _cache_is_flat(kv_cache):
            for name, val in (("k", k_new), ("v", v_new)):
                q, sc = _quant_flat(kv_cache, val.transpose(1, 2))    # [B, T, n_kv, D]
                kv_cache[name][i, :, :t] = q
                kv_cache[name + "_scale"][i, :, :, :t] = sc.transpose(1, 2)
        elif kv_cache is not None:
            kv_cache["k"][i, :, :, :t] = k_new
            kv_cache["v"][i, :, :, :t] = v_new
    return _norm(params["final_norm"], x, cfg), kv_cache


def decode_step(params: Params, cfg: LLMConfig, kv_cache: Params,
                inputs_embeds: torch.Tensor, cache_len: torch.Tensor,
                key_mask: torch.Tensor, write_slot: Optional[int] = None,
                valid_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """One decode step over the heads-layout cache or a flat quantized one.

    inputs_embeds: [B, 1, H]; cache_len: [B] int — logical position per row
    (drives rope; the K/V land at cache_len unless write_slot is given);
    key_mask: [B, L] bool — valid cache slots including this step.
    write_slot: one slot for every row (greedy_generate's uniform layout).
    valid_len: no slot at or past it is valid (flat quantized caches: K4
    skips the length blocks past it).
    The cache is updated in place. Returns (hidden [B, 1, H], kv_cache).
    """
    _check_supported(cfg)
    b = inputs_embeds.shape[0]
    cos, sin = rope_tables(cfg, cache_len[:, None])
    rows = torch.arange(b, device=inputs_embeds.device)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    flat = _cache_is_flat(kv_cache)
    if flat and "k_scale" not in kv_cache:
        raise NotImplementedError("the flat bf16 cache (fused_decode) is not ported yet")
    if not flat and "k_scale" in kv_cache:
        raise NotImplementedError("the heads-layout quantized cache is not ported yet")
    slot = cache_len if write_slot is None else write_slot
    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        q, k1, v1 = _qkv_rope(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg), cos, sin)
        if flat:
            for name, val in (("k", k1), ("v", v1)):
                qv, sc = _quant_flat(kv_cache, val[:, :, 0])          # [B, width], [B, n_kv]
                if write_slot is None:
                    kv_cache[name][i, rows, cache_len] = qv
                    kv_cache[name + "_scale"][i, rows, :, cache_len] = sc
                else:
                    kv_cache[name][i, :, slot] = qv
                    kv_cache[name + "_scale"][i, :, :, slot] = sc
            att = decode_attention_q(
                q[:, :, 0].reshape(b, cfg.num_heads * cfg.head_dim), kv_cache["k"],
                kv_cache["k_scale"], kv_cache["v"], kv_cache["v_scale"], key_mask,
                n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
                pack4=kv_cache["k"].shape[-1] < cfg.num_kv_heads * cfg.head_dim,
                layer=i, valid_len=valid_len)[:, None]
        else:
            if write_slot is not None:
                kv_cache["k"][i, :, :, write_slot] = k1[:, :, 0]
                kv_cache["v"][i, :, :, write_slot] = v1[:, :, 0]
            else:
                kv_cache["k"][i, rows, :, cache_len] = k1[:, :, 0]
                kv_cache["v"][i, rows, :, cache_len] = v1[:, :, 0]
            k_cache = kv_cache["k"][i].to(q.dtype)
            v_cache = kv_cache["v"][i].to(q.dtype)
            att = merge_heads(mha(q, _repeat_kv(k_cache, n_rep), _repeat_kv(v_cache, n_rep),
                                  mask=key_mask[:, None, None, :]))
        x = x + nn.linear(layer["attn"]["o"], att)
        x = x + _mlp(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg)
    return _norm(params["final_norm"], x, cfg), kv_cache
