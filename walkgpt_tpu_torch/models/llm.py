"""Transformer LLM decoder (PyTorch counterpart of walkgpt_tpu/models/llm.py).

The rope family (LLaMA; StableLM's partial rope and GQA) with dense or
quantized weights (W8A8 "a8", weight-only int8, packed int4: fused "qkv4" /
"qkv8" projections, packed MLPs and lm_head; ops/quant.py, ops/int4.py).
Inputs are embeddings, not ids (the multimodal splice happens in
models/walkgpt.py). Full-sequence forwards take a `flash_fn` (the K1 kernel
wrapper) for causal attention with a key mask.

KV caches: the heads layout [layers, B, n_kv, L, D] in the activation dtype
or quantized (int8 or int4 codes, bf16 scales), read by the plain einsum
attention; the flat layout [layers, B, L, n_kv*D] in the activation dtype
(LLMConfig.fused_decode), read by the K11 kernel; the flat quantized layout
(int8 rows or packed int4 rows [.., n_kv*D/2], bf16 scales [layers, B,
n_kv, L]) read by K4 in a decode step and K8 in a speculative chunk. ALiBi
(MPT) and LoRA are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import nn
from ..core.config import LLMConfig
from ..ops import int4
from ..ops.attention import merge_heads, mha, split_heads
from ..ops.flash_attention import decode_attention, decode_attention_q, decode_attention_q_chunk

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
                  device=None, quant="", layout: str = "heads") -> Params:
    """Zeros. layout="heads": {"k", "v"} [layers, B, n_kv, max_len, D] in
    dtype, or with quant "int8" (or True) / "int4" int8 codes with bf16
    scales "k_scale"/"v_scale" [layers, B, n_kv, max_len] and "qmax" (127,
    or 7 for int4: torch has no int4 type, so int4 codes are int8 values in
    [-7, 7], equal to the JAX package's int4 values). layout="flat": {"k",
    "v"} [layers, B, max_len, n_kv*D] in dtype (the fused_decode cache, read
    by K11), or with quant "int8" / "int4" int8 rows (int4: [.., n_kv*D/2]
    packed in global halves) and bf16 scales [layers, B, n_kv, max_len]
    (read by K4 and K8)."""
    if quant not in ("", False, True, "int8", "int4"):
        raise ValueError(f"unknown KV cache quantization {quant!r}")
    kd = cfg.num_kv_heads * cfg.head_dim
    sshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len)
    if layout == "flat":
        shape = (cfg.num_layers, batch, max_len, kd // 2 if quant == "int4" else kd)
    else:
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if not quant:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    cache = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "k_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
             "v_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device)}
    if layout != "flat":
        cache["qmax"] = 7 if quant == "int4" else 127
    return cache


def _cache_is_flat(kv_cache: Params) -> bool:
    return kv_cache["k"].ndim == 4


def _quant_rows(x: torch.Tensor, qmax: int = 127) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 codes [..., D] in [-qmax, qmax], bf16 scale [...]):
    symmetric per row; the scale is rounded to bf16 first and the division
    is by the rounded scale, so the stored pair is self-consistent."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / float(qmax)).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()), -qmax, qmax).to(torch.int8)
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
    """[..., n_kv, D] -> the flat quantized cache's row format: (values
    [..., width], scales [..., n_kv])."""
    n_kv, d = x.shape[-2:]
    if kv_cache["k"].shape[-1] == n_kv * d // 2:
        return _quant_pack4_flat(x)
    q, s = _quant_rows(x)
    return q.reshape(*x.shape[:-2], n_kv * d), s


def _cache_format(kv_cache: Params, x: torch.Tensor):
    """K or V [..., n_kv, D] in the cache's format: (values, scales or None)."""
    if _cache_is_flat(kv_cache):
        if "k_scale" in kv_cache:
            return _quant_flat(kv_cache, x)
        return x.reshape(*x.shape[:-2], -1), None
    if "k_scale" in kv_cache:
        return _quant_rows(x, kv_cache["qmax"])
    return x, None


def _cache_kv(kv_cache: Params, i: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer i's heads-layout K/V [B, n_kv, L, D] in `dtype`; a quantized
    cache is dequantized (codes times scales in fp32)."""
    k, v = kv_cache["k"][i], kv_cache["v"][i]
    if "k_scale" in kv_cache:
        k = k.float() * kv_cache["k_scale"][i][..., None].float()
        v = v.float() * kv_cache["v_scale"][i][..., None].float()
    return k.to(dtype), v.to(dtype)


def _int8_kv_decode_attention(q: torch.Tensor, k_q: torch.Tensor, ks: torch.Tensor,
                              v_q: torch.Tensor, vs: torch.Tensor,
                              key_mask: torch.Tensor) -> torch.Tensor:
    """One-token attention over a heads-layout quantized cache, the scales
    folded outside the products: s = (q * scale) . k_q times ks, masked
    logits -inf then a softmax, out = (p * vs in q's dtype) . v_q.
    q: [B, H, 1, D]; k_q/v_q: [B, n_kv, L, D] codes; ks/vs: [B, n_kv, L];
    key_mask: [B, L]. Returns [B, H, 1, D] in q's dtype."""
    b, h, _, d = q.shape
    n_kv = k_q.shape[1]
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, n_kv, h // n_kv, d)
    s = torch.einsum("bkrd,bkld->bkrl", qg.float(), k_q.to(qg.dtype).float())
    s = s * ks.float()[:, :, None, :]
    s = torch.where(key_mask[:, None, None, :], s, -torch.inf)
    pv = (torch.softmax(s, dim=-1) * vs.float()[:, :, None, :]).to(q.dtype)
    out = torch.einsum("bkrl,bkld->bkrd", pv.float(), v_q.to(pv.dtype).float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def _write_kv(kv_cache: Params, i: int, k: torch.Tensor, v: torch.Tensor, put) -> None:
    """K and V rows [B, T, n_kv, D] into layer i in the cache's format.
    put(buf, length_dim, val [B, T, ...]) writes each leaf; length_dim is
    the length axis of buf[i]: 1 for flat values [B, L, width], 2 for heads
    values [B, n_kv, L, D] and for scales [B, n_kv, L]."""
    for name, x in (("k", k), ("v", v)):
        vals, scales = _cache_format(kv_cache, x)
        buf = kv_cache[name]
        put(buf, 1 if _cache_is_flat(kv_cache) else 2, vals.to(buf.dtype))
        if scales is not None:
            put(kv_cache[name + "_scale"], 2, scales)


def _chunk_slots(cache_len: torch.Tensor, t: int, length: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a chunk of t tokens written at [cache_len, cache_len + t) lands
    in a cache of `length` slots. The JAX package drops the writes past the
    end (those chunk positions are never emitted); here each of them goes to
    the last slot with the value that slot receives anyway, so no index
    wraps, no write is lost and the host is not asked. Returns (slots [B,
    t], src [B, t]): the chunk index whose value each write carries, or t
    for the last slot's current content (a chunk wholly past the end)."""
    j = torch.arange(t, device=cache_len.device)[None]
    pos = cache_len[:, None] + j
    last = length - 1 - cache_len[:, None]           # the chunk index of the last slot
    src = torch.where(pos < length, j, torch.where(last >= 0, last, t))
    return pos.clamp_max(length - 1), src


def _put_chunk(buf: torch.Tensor, i: int, val: torch.Tensor, slots: torch.Tensor,
               src: torch.Tensor, length_dim: int) -> None:
    """val [B, T, ...] into layer i of buf at slots [B, T], write (b, t)
    carrying val[b, src[b, t]] (src = T: the last slot's current value)."""
    rows = torch.arange(val.shape[0], device=val.device)[:, None]
    if length_dim == 1:
        buf[i, rows, slots] = torch.cat([val, buf[i, :, -1][:, None]], 1)[rows, src]
    else:
        buf[i, rows, :, slots] = torch.cat([val, buf[i, :, :, -1][:, None]], 1)[rows, src]


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

    def put(buf, length_dim, val):
        if length_dim == 1:
            buf[i, :, :t] = val
        else:
            buf[i, :, :, :t] = val.transpose(1, 2)

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        h, (k_new, v_new) = _attention(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg),
                                       cos=cos, sin=sin, mask=mask, flash_fn=flash_fn,
                                       key_valid=attention_mask)
        x = x + h
        x = x + _mlp(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg)
        if kv_cache is not None:
            _write_kv(kv_cache, i, k_new.transpose(1, 2), v_new.transpose(1, 2), put)
    return _norm(params["final_norm"], x, cfg), kv_cache


def decode_step(params: Params, cfg: LLMConfig, kv_cache: Params,
                inputs_embeds: torch.Tensor, cache_len: torch.Tensor,
                key_mask: torch.Tensor, write_slot: Optional[int] = None,
                valid_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """One decode step over any of the caches: heads layout (fp: einsum
    attention; quantized: _int8_kv_decode_attention), flat fp (K11) or flat
    quantized (K4).

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
    flat, quant = _cache_is_flat(kv_cache), "k_scale" in kv_cache

    def put(buf, length_dim, val):                  # val [B, 1, ...]: one slot per row
        val = val[:, 0]
        if write_slot is not None:
            if length_dim == 1:
                buf[i, :, write_slot] = val
            else:
                buf[i, :, :, write_slot] = val
        elif length_dim == 1:
            buf[i, rows, cache_len] = val
        else:
            buf[i, rows, :, cache_len] = val

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        q, k1, v1 = _qkv_rope(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg), cos, sin)
        _write_kv(kv_cache, i, k1.transpose(1, 2), v1.transpose(1, 2), put)
        qf = q[:, :, 0].reshape(b, cfg.num_heads * cfg.head_dim)
        if flat and quant:
            att = decode_attention_q(
                qf, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"], kv_cache["v_scale"],
                key_mask, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
                pack4=kv_cache["k"].shape[-1] < cfg.num_kv_heads * cfg.head_dim,
                layer=i, valid_len=valid_len)
        elif flat:
            att = decode_attention(qf, kv_cache["k"], kv_cache["v"], key_mask,
                                   n_kv=cfg.num_kv_heads, layer=i)
        elif quant:
            att = merge_heads(_int8_kv_decode_attention(
                q, kv_cache["k"][i], kv_cache["k_scale"][i], kv_cache["v"][i],
                kv_cache["v_scale"][i], key_mask))[:, 0]
        else:
            k_cache, v_cache = _cache_kv(kv_cache, i, q.dtype)
            att = merge_heads(mha(q, _repeat_kv(k_cache, n_rep), _repeat_kv(v_cache, n_rep),
                                  mask=key_mask[:, None, None, :]))[:, 0]
        x = x + nn.linear(layer["attn"]["o"], att[:, None])
        x = x + _mlp(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg)
    return _norm(params["final_norm"], x, cfg), kv_cache


def decode_chunk(params: Params, cfg: LLMConfig, kv_cache: Params,
                 inputs_embeds: torch.Tensor, cache_len: torch.Tensor
                 ) -> Tuple[torch.Tensor, Params]:
    """T tokens against the cache in one pass: the verify step of
    speculative decode (runtime/generate.speculative_generate).

    inputs_embeds: [B, T, H]; cache_len: [B] int — the first write slot per
    row (token t lands at cache_len + t; the cache is compact per row).
    Token t attends slots [0, cache_len + t]. Heads-layout caches (fp or
    quantized) run the einsum attention over the dequantized layer; the flat
    quantized caches run K8, which reads each cache block once per chunk.
    Writes past the cache's end are dropped (_chunk_slots). The cache is
    updated in place. Returns (hidden [B, T, H], kv_cache)."""
    _check_supported(cfg)
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    flat, quant = _cache_is_flat(kv_cache), "k_scale" in kv_cache
    if flat and not quant:
        raise ValueError("chunk decode over a flat cache needs a quantized one "
                         "(int8_flat / int4_flat)")
    length = kv_cache["k"].shape[2 if flat else 3]
    positions = cache_len[:, None] + torch.arange(t, device=dev)[None]      # [B, T]
    slots, src = _chunk_slots(cache_len, t, length)
    cos, sin = rope_tables(cfg, positions)
    # [B, 1, T, L]: token t attends cache slots <= cache_len + t
    mask = torch.arange(length, device=dev)[None, None, None, :] <= positions[:, None, :, None]
    n_rep = cfg.num_heads // cfg.num_kv_heads

    def put(buf, length_dim, val):
        _put_chunk(buf, i, val, slots, src, length_dim)

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        q, k1, v1 = _qkv_rope(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg), cos, sin)
        _write_kv(kv_cache, i, k1.transpose(1, 2), v1.transpose(1, 2), put)
        if flat:
            att = decode_attention_q_chunk(
                merge_heads(q), kv_cache["k"], kv_cache["k_scale"], kv_cache["v"],
                kv_cache["v_scale"], cache_len, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
                pack4=kv_cache["k"].shape[-1] < cfg.num_kv_heads * cfg.head_dim, layer=i)
        else:
            k_cache, v_cache = _cache_kv(kv_cache, i, q.dtype)
            att = merge_heads(mha(q, _repeat_kv(k_cache, n_rep), _repeat_kv(v_cache, n_rep),
                                  mask=mask))
        x = x + nn.linear(layer["attn"]["o"], att)
        x = x + _mlp(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg)
    return _norm(params["final_norm"], x, cfg), kv_cache
