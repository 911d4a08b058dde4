"""The fused decode-layer tail (PyTorch counterpart of
walkgpt_tpu/ops/fused_layer.py).

K12 fused_layer_tail (csrc/fused_layer.cu)
    Replaces walkgpt_tpu/ops/fused_layer.py:fused_layer_tail (_kernel): one
    launch per layer of a greedy decode step over the quantized flat cache,
    folding everything after the q/k/v projection, rope and cache write:

        att = K4's attention of q (banded_q8's codes) over the cache, fp32
        x2  = bf16(x + (quant8(att) @ o_wq) * as * o_scale)     (W8A8 o-proj)
        h   = bf16(rms_norm(x2) * post_scale)
        y   = x2 + mlp_int4(h)                                  (K6's tiles)

    y is fp32; the caller casts it to the residual stream's dtype. The
    o-proj's quantizer is the TPU kernel's, not nn.linear's: sr = max(|att|
    max, 1e-8) * (1/127), codes round(att / sr) with a true division.

models/llm.decode_step takes it with `fused_layer=True` (the JAX package's
WALKGPT_FUSED_LAYER) on the layers layer_tail_supported accepts: a W8A8
o-proj, an int4 MLP, RMSNorm and MHA (n_kv * D == hidden). On the card it is
one cooperative launch whose blocks meet at a grid barrier between the
phases (attention per (row, kv head); o-proj column tiles; MLP intermediate
tiles; the in-order sum of the tiles); on CPU tensors the plain version
runs. Bound (7B, 2 rows, 480 of 512 slots valid): bytes, about 88 MB of
weights and cache per launch, about 26 us at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ..core.nn import int8_matmul
from . import cuda_build, int4
from .flash_attention import (DECODE_BLOCK, _check_contiguous, _check_quant_cache,
                              _decode_blocks, _walk_blocks)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 21 + [_I] * 10 + [_F, _F, _I, _I, _P]


def layer_tail_supported(layer_p: Dict, cfg) -> bool:
    """True when this layer's formats match the fused tail kernel: W8A8 o
    projection (no bias or LoRA), int4 MLP, RMSNorm, attention width ==
    hidden size. cfg: the LLMConfig."""
    o = layer_p["attn"].get("o")
    if not (isinstance(o, dict) and "w_q" in o and "a8" in o
            and "b" not in o and "lora_a" not in o):
        return False
    if not int4.mlp_is_int4(layer_p["mlp"]):
        return False
    if cfg.norm != "rmsnorm":
        return False
    return cfg.num_heads * cfg.head_dim == cfg.hidden_size


def _check_mha(x: torch.Tensor, n_kv: int, head_dim: int) -> None:
    if n_kv * head_dim != x.shape[-1]:
        raise ValueError(f"fused_layer_tail assumes attention width == hidden (MHA): "
                         f"n_kv * head_dim = {n_kv * head_dim}, hidden {x.shape[-1]}")


def fused_layer_tail_reference(x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask,
                               o_p, post_norm_scale, mlp_p, *, n_kv: int, head_dim: int,
                               pack4: bool, layer: int, act: str, norm_eps: float,
                               block: int = DECODE_BLOCK,
                               valid_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of K12, the TPU kernel's arithmetic step by step:
    the block walk on q8 (_walk_blocks), the fp32 rows; sr, the codes and
    the int32 o product, x2 = bf16(x + (acc * sr) * os); hn = bf16((x2 *
    (1 / sqrt(mean(x2^2) + eps))) * pn); K6's tile partials of hn
    (int4.mlp4_tile_parts); y = x2 + the partials in tile order."""
    _check_mha(x, n_kv, head_dim)
    b, hd = x.shape
    bl, nvb = _decode_blocks(k_cache.shape[2], block, valid_len)
    scale = 1.0 / math.sqrt(head_dim)
    att = _walk_blocks(q8.float()[:, None], (qs * scale)[:, None, ..., None], k_cache,
                       k_scale, v_cache, v_scale, lambda keys: key_mask[:, None, keys], nvb,
                       pack4=pack4, layer=layer, bl=bl).reshape(b, hd)
    sr = att.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    att8 = torch.clamp(torch.round(att / sr), -127, 127).to(torch.int8)
    part = int8_matmul(att8, o_p["w_q"]).float() * sr * o_p["w_scale"]
    x2 = (x.float() + part).to(torch.bfloat16).float()
    var = x2.square().mean(-1, keepdim=True)
    hn = (x2 * (1.0 / torch.sqrt(var + norm_eps)) * post_norm_scale.float()).to(torch.bfloat16)
    y = x2
    for tile_part in int4.mlp4_tile_parts(mlp_p, hn, act):
        y = y + tile_part
    return y


def fused_layer_tail(x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask, o_p,
                     post_norm_scale, mlp_p, *, n_kv: int, head_dim: int, pack4: bool,
                     layer: int, act: str, norm_eps: float, block: int = DECODE_BLOCK,
                     valid_len: Optional[int] = None) -> torch.Tensor:
    """K12: one decode layer's tail in one launch.

    x: [B, H] the layer's input (the residual stream before the input
    norm); q8 int8 [B, n_kv, 1, D] and qs fp32 [B, n_kv, 1]: banded_q8 of
    the step's roped q; the caches and key_mask as for decode_attention_q
    (the step's K/V already written); o_p {"w_q" [H, H] int8, "w_scale" [H]
    fp32, "a8"}; post_norm_scale [H]; mlp_p {"gate", "up": {w_p4, w_scale},
    "down": {w_p4t, w_scale}} (act "silu") or {"fc1", "fc2"} (gelu);
    valid_len: whole length blocks at or past it are skipped. Returns fp32
    [B, H] = x2 + mlp(norm(x2)); on the card it is row 2 of the launch's
    scratch [attention rows, x2, y, the MLP tiles' partials] (its `_base`),
    where a check can read the fp32 attention rows."""
    _check_mha(x, n_kv, head_dim)
    if x.device.type == "cpu":
        return fused_layer_tail_reference(
            x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask, o_p, post_norm_scale,
            mlp_p, n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, act=act,
            norm_eps=norm_eps, block=block, valid_len=valid_len)
    name = "fused_layer_tail"
    b, hd = x.shape
    d = head_dim
    l = k_cache.shape[2]
    bl, nvb = _decode_blocks(l, block, valid_len)
    first, up, down, gelu = int4._mlp_parts(mlp_p, act)
    i_dim = first["w_p4"].shape[1]
    tile = int4.tile_for(i_dim)
    if (x.dtype not in _DTYPES or post_norm_scale.dtype not in _DTYPES
            or tuple(q8.shape) != (b, n_kv, 1, d) or q8.dtype != torch.int8
            or tuple(qs.shape) != (b, n_kv, 1) or qs.dtype != torch.float32
            or tuple(key_mask.shape) != (b, l) or key_mask.dtype != torch.bool
            or tuple(o_p["w_q"].shape) != (hd, hd) or o_p["w_q"].dtype != torch.int8
            or tuple(o_p["w_scale"].shape) != (hd,) or o_p["w_scale"].dtype != torch.float32
            or tuple(post_norm_scale.shape) != (hd,) or hd % 4
            or tuple(first["w_p4"].shape) != (hd // 2, i_dim)
            or tuple(down["w_p4t"].shape) != (i_dim // 2, hd)):
        raise ValueError(f"{name}: bad inputs x {tuple(x.shape)} {x.dtype}, q8 "
                         f"{tuple(q8.shape)}, qs {tuple(qs.shape)}, mask {tuple(key_mask.shape)}"
                         f", o {tuple(o_p['w_q'].shape)}, mlp {tuple(first['w_p4'].shape)} / "
                         f"{tuple(down['w_p4t'].shape)}")
    _check_quant_cache(name, b, n_kv, d, l, pack4, k_cache, k_scale, v_cache, v_scale)
    ups = (up["w_p4"], up["w_scale"]) if up is not None else (None, None)
    bufs = [q8, qs, k_cache[layer], k_scale[layer], v_cache[layer], v_scale[layer], key_mask,
            x, o_p["w_q"], o_p["w_scale"], post_norm_scale, first["w_p4"], first["w_scale"],
            *[t for t in ups if t is not None], down["w_p4t"], down["w_scale"]]
    _check_contiguous(name, x.device, *bufs)
    # scratch: attention rows, x2, y, then the MLP tiles' partials
    buf = torch.empty((3 + i_dim // tile, b, hd), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.launch(
        "fused_layer", "wg_fused_layer_tail", _ARGTYPES, x.device,
        q8.data_ptr(), qs.data_ptr(), k_cache[layer].data_ptr(), k_scale[layer].data_ptr(),
        v_cache[layer].data_ptr(), v_scale[layer].data_ptr(), key_mask.data_ptr(),
        x.data_ptr(), o_p["w_q"].data_ptr(), o_p["w_scale"].data_ptr(),
        post_norm_scale.data_ptr(), first["w_p4"].data_ptr(), first["w_scale"].data_ptr(),
        ptr(ups[0]), ptr(ups[1]), down["w_p4t"].data_ptr(), down["w_scale"].data_ptr(),
        buf[0].data_ptr(), buf[1].data_ptr(), buf[3].data_ptr(), buf[2].data_ptr(),
        b, n_kv, d, l, bl, nvb, int(pack4), i_dim, tile, int(gelu),
        1.0 / math.sqrt(d), norm_eps, _DTYPES[x.dtype], _DTYPES[post_norm_scale.dtype])
    fused_layer_tail.launches += 1
    return buf[2]


fused_layer_tail.launches = 0

KERNELS = (fused_layer_tail,)
