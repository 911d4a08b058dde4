"""Transformer LLM decoder (PyTorch counterpart of walkgpt_tpu/models/llm.py).

The rope family (LLaMA; StableLM's partial rope and GQA) and MPT's ALiBi
(LayerNorm, GELU MLP, tied embeddings; the bias enters the plain attention,
never K1, and only the heads-layout caches decode it) with dense or
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
n_kv, L]) read by K4 in a decode step and K8 in a speculative chunk, or,
with decode_step(fused_layer=True) on a layer of the int4x format, by K12,
which runs that layer's attention, o-proj, residual, norm and MLP in one
launch.

Manual tensor parallelism (parallel/tp.py): with `tp` (a parallel/dist.Axis)
the params and cfg are one rank's head and intermediate shard, the o- and
down-projections are row-parallel and their partial outputs are summed over
the tp ranks (_psum_tp: two per layer, dist.reduce_from, so that a forward
with gradients passes the gradient through as it is), the normed inputs of
the column-parallel q/k/v (with their LoRA branch) and gate/up projections
go through dist.copy_to in `forward` (the gradient of those inputs summed
over the tp ranks in the backward pass, also when remat recomputes a
block), the W8A8 quantizer of those
projections takes the tp ranks' largest absmax (_amax_reduce_for), K7 and
K12 are not used (their fusions cross the sum), and ALiBi is refused (its
slopes index the global heads), all as in the JAX package's tp_axis.

The GSPMD leg (parallel/gspmd.py): with `tp` a GspmdAxis the params are the
rank's blocks under JAX's param_pspecs and cfg the rank's head shard
(GspmdAxis.local_llm): q/k/v take the rank's heads' columns (of the whole
fused qkv4 / qkv8 product, which is replicated), the o- and split MLP
projections are row-parallel with the bias after the sum, the packed int4
MLP (K6) runs whole without a sum, the embedding and the head are split
over tp (embed, lm_logits), and ALiBi takes the slopes of the rank's
global head indices.

LoRA: a q/k/v projection with "lora_a" [in, r] and "lora_b" [r, out]
leaves adds (x @ lora_a) @ lora_b * lora_scale in the activation dtype
(runtime/lora.py makes and merges the adapters). `forward(remat=True)`
recomputes each block in the backward pass (torch.utils.checkpoint).

_FUSED_MLP8 (the JAX package's WALKGPT_FUSED_MLP8, read at import, default
on): W8A8 MLPs take K7 on decode rows; off, the per-projection W8A8 path.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import nn
from ..core.config import LLMConfig
from ..ops import int4
from ..parallel.dist import copy_to, reduce_from
from ..parallel.gspmd import is_gspmd
from ..ops.attention import merge_heads, mha, split_heads
from ..ops.flash_attention import (banded_q8, decode_attention, decode_attention_q,
                                   decode_attention_q_chunk)
from ..ops import fused_layer as fl
from ..ops.fused_layer import fused_layer_tail, layer_tail_supported

Params = Dict

# K7 for W8A8 MLPs on decode rows (WALKGPT_FUSED_MLP8=0: the per-projection
# W8A8 products), read at call time by _mlp
_FUSED_MLP8 = os.environ.get("WALKGPT_FUSED_MLP8", "1") == "1"


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


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """The ALiBi slopes: powers of 2^(-8/n), with the interleaved fallback
    for a head count that is not a power of two. [num_heads] fp32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]
    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][:num_heads - closest]
    return torch.tensor(s, dtype=torch.float32, device=device)


def _slopes(cfg: LLMConfig, tp, device) -> torch.Tensor:
    """The ALiBi slopes of cfg's heads; under the GSPMD leg, of the rank's
    global head indices."""
    if not is_gspmd(tp):
        return alibi_slopes(cfg.num_heads, device)
    s = alibi_slopes(tp.llm.num_heads, device)
    return tp.part(s) if cfg.num_heads != tp.llm.num_heads else s


def alibi_bias(cfg: LLMConfig, q_pos: torch.Tensor, k_pos: torch.Tensor, tp=None) -> torch.Tensor:
    """[H, Tq, Tk] additive bias: -slope * (q - k), 0 on and above the
    diagonal. fp32."""
    dist = (q_pos[:, None] - k_pos[None, :]).float().clamp_min(0.0)
    return -_slopes(cfg, tp, q_pos.device)[:, None, None] * dist[None]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _norm(p, x, cfg: LLMConfig):
    if cfg.norm == "rmsnorm":
        return nn.rms_norm(p, x, eps=cfg.norm_eps)
    return nn.layer_norm(p, x, eps=cfg.norm_eps)


def _amax_reduce_for(tp):
    """The W8A8 quantizer's hook for the row-parallel projections under tp
    (core/nn.linear amax_reduce): the pmax over the tp ranks, so every rank
    quantizes with the single device's per-token absmax. None without tp."""
    return None if tp is None else tp.pmax


def _manual(tp):
    """tp where it is a manual tp axis, None under the GSPMD leg (whose
    collectives carry no gradient) and without tp."""
    return None if is_gspmd(tp) else tp


def _psum_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """The megatron reduction point: under tp the o- and down-projections
    are row-parallel, so each rank holds a partial sum of the residual
    stream's update; the sum over the tp ranks makes it whole again (the
    same bits on every rank; its gradient passes through as it is). The
    identity without tp."""
    return reduce_from(tp, x)


def _mlp(p, x, cfg: LLMConfig, tp=None):
    """Packed int4 MLPs take K6 on decode rows; W8A8 MLPs take K7 on decode
    rows under _FUSED_MLP8 (fused_mlp_int8 returns None for longer inputs)
    and without tp (K7 requantizes the intermediate per tile_for(I) group,
    which re-bins at the local intermediate); the rest the per-projection
    products, the down-projection's quantizer under tp with the pmax hook.
    Under tp the result is this rank's partial sum."""
    if int4.mlp_is_int4(p):
        return int4.mlp_int4(p, x, cfg.act)
    if _FUSED_MLP8 and int4.mlp_is_w8a8(p) and tp is None:
        y = int4.fused_mlp_int8(p, x, cfg.act)
        if y is not None:
            return y
    red = _amax_reduce_for(tp)
    if cfg.act == "silu":
        return nn.linear(p["down"], F.silu(nn.linear(p["gate"], x)) * nn.linear(p["up"], x),
                         amax_reduce=red)
    return nn.linear(p["fc2"], nn.gelu_exact(nn.linear(p["fc1"], x)), amax_reduce=red)


def _mlp_update(p, x, cfg: LLMConfig, tp=None):
    """The MLP's update of the residual stream, whole on every rank: under
    manual tp _mlp's partial sums summed; under the GSPMD leg the split
    gate/up (fc1) columns and down (fc2) rows of a dense or int8 MLP
    through GspmdAxis.row, and a replicated MLP (packed int4: K6) whole."""
    if not is_gspmd(tp):
        return _psum_tp(_mlp(p, x, cfg, tp), tp)
    silu = cfg.act == "silu"
    if not tp.is_split(p["gate" if silu else "fc1"]):
        return _mlp(tp.packed(p), x, cfg)
    if silu:
        h = F.silu(nn.linear(p["gate"], x)) * nn.linear(p["up"], x)
    else:
        h = nn.gelu_exact(nn.linear(p["fc1"], x))
    return tp.row(p["down" if silu else "fc2"], h)


def _o_update(p, att: torch.Tensor, tp=None) -> torch.Tensor:
    """The attention output projection's update of the residual stream,
    whole on every rank (att: the merged heads, the rank's under tp)."""
    if is_gspmd(tp):
        return tp.row(p, att)
    return _psum_tp(nn.linear(p, att, amax_reduce=_amax_reduce_for(tp)), tp)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = nn._promote(a, b)
    return a @ b


def _proj(p, x: torch.Tensor) -> torch.Tensor:
    """nn.linear plus the LoRA term when the projection carries adapters.
    The low-rank products promote as in the JAX package (a bf16 x meets fp32
    adapters in fp32); the term is scaled in fp32 and rounded once to the
    projection's dtype, so an fp32 lora_scale does not upcast a bf16
    residual stream."""
    y = nn.linear(p, x)
    if "lora_a" in p:
        t = _matmul(_matmul(x, p["lora_a"]), p["lora_b"])
        y = y + (t.float() * p.get("lora_scale", 1.0)).to(y.dtype)
    return y


def _qkv_proj(p, x: torch.Tensor, cfg: LLMConfig, tp=None):
    """q/k/v projections: one packed int4 product (K5 on decode rows) for
    "qkv4", one W8A8 product for "qkv8", else three (each with its LoRA
    term, if any). Under the GSPMD leg, the rank's heads' columns of each
    (of the whole fused product: qkv4 and qkv8 are replicated)."""
    g = cfg if not is_gspmd(tp) else tp.llm
    part = cfg.num_heads != g.num_heads             # the rank runs its heads only
    if "qkv4" in p or "qkv8" in p:
        hq, kvd = g.num_heads * g.head_dim, g.num_kv_heads * g.head_dim
        qkv = (int4.int4_matmul_pallas(x, p["qkv4"]["w_p4"], p["qkv4"]["w_scale"])
               if "qkv4" in p else nn.linear(p["qkv8"], x))
        out = qkv[..., :hq], qkv[..., hq:hq + kvd], qkv[..., hq + kvd:]
        return out if not is_gspmd(tp) else tuple(tp.fit(y, False, part) for y in out)
    if not is_gspmd(tp):
        return _proj(p["q"], x), _proj(p["k"], x), _proj(p["v"], x)
    return tuple(tp.column(p[n], x, part, _proj) for n in ("q", "k", "v"))


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, n_kv, T, D] -> [B, n_kv*n_rep, T, D] (GQA repeat)."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def _qkv_rope(p, cfg: LLMConfig, x: torch.Tensor, cos, sin, tp=None):
    """q [B, H, T, D], k and v [B, n_kv, T, D]; roped unless cos is None
    (ALiBi)."""
    qp, kp, vp = _qkv_proj(p, x, cfg, tp)
    q = split_heads(qp, cfg.num_heads)
    k = split_heads(kp, cfg.num_kv_heads)
    v = split_heads(vp, cfg.num_kv_heads)
    if cos is None:
        return q, k, v
    rot_dim = int(cfg.head_dim * cfg.rope_pct)
    return apply_rope(q, cos, sin, rot_dim), apply_rope(k, cos, sin, rot_dim), v


def _attention(p, cfg: LLMConfig, x: torch.Tensor, *, cos, sin,
               mask: torch.Tensor, flash_fn=None,
               key_valid: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, tp=None):
    """Full-sequence self-attention. Returns (output, (k, v)) with the new
    keys/values [B, n_kv, T, D] (pre-repeat, post-rope) for the cache.
    flash_fn(q, k, v, key_valid) implements causal attention (K1); with an
    ALiBi bias the plain attention runs instead, as in the JAX package.
    The output is the whole update of the residual stream (_o_update)."""
    q, k, v = _qkv_rope(p, cfg, x, cos, sin, tp)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if flash_fn is not None and bias is None:
        out = flash_fn(q, kr, vr, key_valid)
    else:
        out = mha(q, kr, vr, mask=mask, bias=bias)
    return _o_update(p["o"], merge_heads(out), tp), (k, v)


def lm_logits(params: Params, cfg: LLMConfig, hidden: torch.Tensor, tp=None) -> torch.Tensor:
    """The logits of hidden. Under the GSPMD leg: a tied head multiplies by
    the rank's vocabulary rows and gathers the slices over tp; a dense or
    int8 head [H, V] split on H is row-parallel (GspmdAxis.row: partial
    logits summed over tp); the packed int4 head runs whole (K5)."""
    if cfg.tie_embeddings:
        logits = hidden @ params["embed_tokens"]["w"].T
        return (tp.fit(logits, tp.is_split(params["embed_tokens"]), False) if is_gspmd(tp)
                else logits)
    head = params["lm_head"]
    if "w_p4" in head and "b" not in head:
        # K5 on decode rows; the packed head may be zero-padded to a
        # multiple of 128 columns: slice back to the vocabulary
        logits = int4.int4_matmul_pallas(hidden, head["w_p4"], head["w_scale"])
        return logits[..., :cfg.vocab_size]
    if is_gspmd(tp):
        return tp.row(head, hidden)
    return nn.linear(head, hidden)


def embed(params: Params, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """The embedding lookup; under the GSPMD leg over the rank's vocabulary
    rows and summed over tp (GspmdAxis.embed)."""
    if is_gspmd(tp):
        return tp.embed(params["embed_tokens"]["w"], ids)
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
    scale = nn.div_exact(xf.abs().amax(-1, keepdim=True).clamp_min(1e-8), qmax)
    scale = scale.to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()), -qmax, qmax).to(torch.int8)
    return q, scale[..., 0]


def _quant_pack4_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n_kv, D] -> (packed int8 [..., n_kv*D/2], bf16 scale [...,
    n_kv]): per (row, kv head) int4 (7 levels) divided by the rounded bf16
    scale, packed in GLOBAL halves of the flattened row: byte j holds flat
    dims j (low nibble) and j + n_kv*D/2 (high nibble)."""
    xf = x.float()
    scale = nn.div_exact(xf.abs().amax(-1, keepdim=True).clamp_min(1e-8), 7.0)
    scale = scale.to(torch.bfloat16)
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


def _cache_kv(kv_cache: Params, i: int, dtype, attend_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer i's heads-layout K/V [B, n_kv, L, D] in `dtype`; a quantized
    cache is dequantized (codes times scales in fp32). attend_len: the
    prefix [0, attend_len) of the length axis alone (a view)."""
    al = slice(None, attend_len)
    k, v = kv_cache["k"][i][:, :, al], kv_cache["v"][i][:, :, al]
    if "k_scale" in kv_cache:
        k = k.float() * kv_cache["k_scale"][i][:, :, al, None].float()
        v = v.float() * kv_cache["v_scale"][i][:, :, al, None].float()
    return k.to(dtype), v.to(dtype)


def _int8_kv_decode_attention(q: torch.Tensor, k_q: torch.Tensor, ks: torch.Tensor,
                              v_q: torch.Tensor, vs: torch.Tensor,
                              key_mask: torch.Tensor,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention over a heads-layout quantized cache, the scales
    folded outside the products: s = (q * scale) . k_q times ks, plus the
    ALiBi bias [B, H, 1, L] if any, masked logits -inf then a softmax, out
    = (p * vs in q's dtype) . v_q. q: [B, H, 1, D]; k_q/v_q: [B, n_kv, L,
    D] codes; ks/vs: [B, n_kv, L]; key_mask: [B, L]. Returns [B, H, 1, D]
    in q's dtype."""
    b, h, _, d = q.shape
    n_kv = k_q.shape[1]
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, n_kv, h // n_kv, d)
    s = torch.einsum("bkrd,bkld->bkrl", qg.float(), k_q.to(qg.dtype).float())
    s = s * ks.float()[:, :, None, :]
    if bias is not None:
        s = s + bias.reshape(b, n_kv, h // n_kv, k_q.shape[2])
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

def _block(layer: Params, cfg: LLMConfig, x: torch.Tensor, cos, sin, mask, flash_fn,
           key_valid, bias, tp=None):
    h, kv = _attention(layer["attn"], cfg,
                       copy_to(_manual(tp), _norm(layer["input_norm"], x, cfg)),
                       cos=cos, sin=sin, mask=mask, flash_fn=flash_fn, key_valid=key_valid,
                       bias=bias, tp=tp)
    x = x + h
    hn = copy_to(_manual(tp), _norm(layer["post_norm"], x, cfg))
    return x + _mlp_update(layer["mlp"], hn, cfg, tp), kv


def refuse_alibi_tp(cfg: LLMConfig, tp) -> None:
    """ALiBi under manual tp raises, as in the JAX package: here in forward
    and decode_step, and in parallel/tp.tp_llm_cfg before any rank starts.
    The GSPMD leg runs it."""
    if tp is not None and not is_gspmd(tp) and cfg.pos_emb == "alibi":
        raise NotImplementedError(
            "manual tp: ALiBi slopes index the global heads; the JAX package refuses "
            "it too, and no item of ROADMAP.md's Queue 1 ports it")


def forward(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor, *,
            attention_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[Params] = None,
            flash_fn=None, remat: bool = False,
            tp=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence (training / prefill) forward.

    inputs_embeds: [B, T, H]; attention_mask: [B, T] bool (True = real token).
    Positions default to cumsum(mask) - 1 per row. kv_cache, when given, is
    written IN PLACE at slots [0, T) of every layer (the port's caches are
    mutable buffers). remat=True keeps only each block's input for the
    backward pass and recomputes the block there (torch.utils.checkpoint,
    the JAX package's jax.checkpoint with nothing saveable). Returns
    (final-norm hidden states [B, T, H], kv_cache). ALiBi models add the
    bias of positions 0 .. T-1 (the JAX package's, whatever the mask) in
    the plain attention; flash_fn is then not called. tp: this rank's axis
    of a manual tp mesh or a GspmdAxis (module docstring), params and cfg
    its shard.
    """
    refuse_alibi_tp(cfg, tp)
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
    cos = sin = bias = None
    if cfg.pos_emb == "alibi":
        pos = torch.arange(t, device=dev)
        bias = alibi_bias(cfg, pos, pos, tp)[None]
    else:
        cos, sin = rope_tables(cfg, positions)

    def put(buf, length_dim, val):
        if length_dim == 1:
            buf[i, :, :t] = val
        else:
            buf[i, :, :, :t] = val.transpose(1, 2)

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        args = (layer, cfg, x, cos, sin, mask, flash_fn, attention_mask, bias, tp)
        if remat:
            x, (k_new, v_new) = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, (k_new, v_new) = _block(*args)
        if kv_cache is not None:
            _write_kv(kv_cache, i, k_new.transpose(1, 2), v_new.transpose(1, 2), put)
    return _norm(params["final_norm"], x, cfg), kv_cache


def decode_step(params: Params, cfg: LLMConfig, kv_cache: Params,
                inputs_embeds: torch.Tensor, cache_len: torch.Tensor,
                key_mask: torch.Tensor, write_slot: Optional[int] = None,
                attend_len: Optional[int] = None,
                valid_len: Optional[int] = None,
                fused_layer: Optional[bool] = None, tp=None) -> Tuple[torch.Tensor, Params]:
    """One decode step over any of the caches: heads layout (fp: einsum
    attention; quantized: _int8_kv_decode_attention), flat fp (K11) or flat
    quantized (K4). ALiBi models decode over the heads layout alone.

    fused_layer (default ops/fused_layer.FUSED_LAYER, the JAX package's
    WALKGPT_FUSED_LAYER): over a flat quantized cache, each layer that
    ops/fused_layer.layer_tail_supported accepts (W8A8 o-proj, int4 MLP,
    RMSNorm, MHA) runs its attention, o-proj, residual, post-norm and MLP
    as one K12 launch; other layers and caches take the unfused path.

    inputs_embeds: [B, 1, H]; cache_len: [B] int — logical position per row
    (drives rope or ALiBi; the K/V land at cache_len unless write_slot is
    given); key_mask: [B, attend_len or L] bool — valid cache slots
    including this step. write_slot: one slot for every row
    (greedy_generate's uniform layout). attend_len: the attention reads the
    slots [0, attend_len) alone (heads layout; the caller guarantees every
    valid slot is below it: greedy_generate's growing-cache segments);
    writes still reach the whole buffer. valid_len: no slot at or past it
    is valid (flat quantized caches: K4 skips the length blocks past it).
    tp: this rank's axis of a manual tp mesh (module docstring): params,
    cfg and cache are its kv-head shard, and K12 is skipped (the sum over
    the ranks falls inside its fusion). The cache is updated in place.
    Returns (hidden [B, 1, H], kv_cache).
    """
    refuse_alibi_tp(cfg, tp)
    b = inputs_embeds.shape[0]
    rows = torch.arange(b, device=inputs_embeds.device)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    flat, quant = _cache_is_flat(kv_cache), "k_scale" in kv_cache
    if fused_layer is None:
        fused_layer = fl.FUSED_LAYER
    cos = sin = bias = None
    if flat and attend_len is not None:
        raise ValueError("attend_len prefix reads are heads-layout only")
    if flat and cfg.pos_emb == "alibi":
        raise NotImplementedError("flat-cache decode supports rope/no-bias models; "
                                  "use the heads-layout cache for ALiBi")
    if cfg.pos_emb == "alibi":
        # [B, H, 1, L]: -slope * max(cache_len - slot, 0) over every slot
        k_pos = torch.arange(kv_cache["k"].shape[3], device=cache_len.device)
        dist = (cache_len[:, None, None] - k_pos[None, None]).float().clamp_min(0.0)
        bias = -_slopes(cfg, tp, cache_len.device)[None, :, None, None] * dist[:, None]
        if attend_len is not None:
            bias = bias[..., :attend_len]
    else:
        cos, sin = rope_tables(cfg, cache_len[:, None])
    # per-row slots: a row at or past the cache's end (the continuous
    # batcher's rows that run past their budget within a segment, whose
    # outputs are dropped) writes the last slot, which it alone reads; the
    # JAX package drops that write. No index leaves the buffer.
    slot = cache_len.clamp_max(kv_cache["k"].shape[2 if flat else 3] - 1)
    al = slice(None, attend_len)

    def put(buf, length_dim, val):                  # val [B, 1, ...]: one slot per row
        val = val[:, 0]
        if write_slot is not None:
            if length_dim == 1:
                buf[i, :, write_slot] = val
            else:
                buf[i, :, :, write_slot] = val
        elif length_dim == 1:
            buf[i, rows, slot] = val
        else:
            buf[i, rows, :, slot] = val

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        q, k1, v1 = _qkv_rope(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg), cos, sin,
                              tp)
        _write_kv(kv_cache, i, k1.transpose(1, 2), v1.transpose(1, 2), put)
        qf = q[:, :, 0].reshape(b, cfg.num_heads * cfg.head_dim)
        pack4 = kv_cache["k"].shape[-1] < cfg.num_kv_heads * cfg.head_dim
        if flat and quant and fused_layer and tp is None and layer_tail_supported(layer, cfg):
            q8, qs = banded_q8(qf, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim)
            y = fused_layer_tail(
                x[:, 0], q8, qs, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"],
                kv_cache["v_scale"], key_mask, layer["attn"]["o"], layer["post_norm"]["scale"],
                layer["mlp"], n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim, pack4=pack4,
                layer=i, act=cfg.act, norm_eps=cfg.norm_eps, valid_len=valid_len)
            x = y.to(x.dtype)[:, None]
            continue
        if flat and quant:
            att = decode_attention_q(
                qf, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"], kv_cache["v_scale"],
                key_mask, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim, pack4=pack4,
                layer=i, valid_len=valid_len)
        elif flat:
            att = decode_attention(qf, kv_cache["k"], kv_cache["v"], key_mask,
                                   n_kv=cfg.num_kv_heads, layer=i)
        elif quant:
            att = merge_heads(_int8_kv_decode_attention(
                q, kv_cache["k"][i][:, :, al], kv_cache["k_scale"][i][:, :, al],
                kv_cache["v"][i][:, :, al], kv_cache["v_scale"][i][:, :, al], key_mask,
                bias=bias))[:, 0]
        else:
            k_cache, v_cache = _cache_kv(kv_cache, i, q.dtype, attend_len=attend_len)
            att = merge_heads(mha(q, _repeat_kv(k_cache, n_rep), _repeat_kv(v_cache, n_rep),
                                  mask=key_mask[:, None, None, :], bias=bias))[:, 0]
        x = x + _o_update(layer["attn"]["o"], att[:, None], tp)
        x = x + _mlp_update(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg, tp)
    return _norm(params["final_norm"], x, cfg), kv_cache


def decode_chunk(params: Params, cfg: LLMConfig, kv_cache: Params,
                 inputs_embeds: torch.Tensor, cache_len: torch.Tensor, tp=None
                 ) -> Tuple[torch.Tensor, Params]:
    """T tokens against the cache in one pass: the verify step of
    speculative decode (runtime/generate.speculative_generate).

    inputs_embeds: [B, T, H]; cache_len: [B] int — the first write slot per
    row (token t lands at cache_len + t; the cache is compact per row).
    Token t attends slots [0, cache_len + t]. Heads-layout caches (fp or
    quantized) run the einsum attention over the dequantized layer; the flat
    quantized caches run K8, which reads each cache block once per chunk.
    Writes past the cache's end are dropped (_chunk_slots). The cache is
    updated in place. Returns (hidden [B, T, H], kv_cache). Rope models
    only, as in the JAX package. tp: as decode_step's."""
    if cfg.pos_emb == "alibi":
        raise NotImplementedError("speculative chunk decode: rope models")
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
        q, k1, v1 = _qkv_rope(layer["attn"], cfg, _norm(layer["input_norm"], x, cfg), cos, sin,
                              tp)
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
        x = x + _o_update(layer["attn"]["o"], att, tp)
        x = x + _mlp_update(layer["mlp"], _norm(layer["post_norm"], x, cfg), cfg, tp)
    return _norm(params["final_norm"], x, cfg), kv_cache
