"""The fused decode-layer tail (PyTorch counterpart of
walkgpt_tpu/ops/fused_layer.py).

K12 fused_layer_tail (csrc/fused_layer.cu)
    Replaces walkgpt_tpu/ops/fused_layer.py:fused_layer_tail (_kernel): one
    launch per layer of a greedy decode step over the quantized flat cache,
    folding everything after the q/k/v projection, rope and cache write:

        att = K4's attention of q (banded_q8's codes) over the cache, fp32
        x2  = bf16(x + (quant8(att) @ o_wq) * as * o_scale)     (W8A8 o-proj)
        hn  = bf16(rms_norm(x2) * post_scale)
        y   = x2 + mlp_int4(hn)                                 (K6's passes)

    y is fp32; the caller casts it to the residual stream's dtype. The
    o-proj's quantizer is the TPU kernel's, not nn.linear's: sr = max(|att|
    max, 1e-8) * (1/127), codes round(att / sr) with a true division.

models/llm.decode_step takes it with `fused_layer=True` (default FUSED_LAYER,
read from the JAX package's WALKGPT_FUSED_LAYER at import) on the layers layer_tail_supported accepts: a W8A8
o-proj, an int4 MLP, RMSNorm and MHA (n_kv * D == hidden). On the card it is
one cooperative launch of two 256-thread blocks an SM whose blocks run the
port's other engines grid-strided and meet at a grid barrier between the
phases (fused_layer_tail_plan): attention per (row, kv head, 64 value dims)
on K4's engine; the o-proj, 32 columns an item, on K7's dp4a product loop;
RMSNorm and K6's gate/up pass; K6's down pass; the in-order sum of the
tiles. On CPU tensors the plain version runs. Bound (7B, 2 rows, 480 of
512 slots valid): bytes, about 88 MB of weights and cache per launch,
about 26 us at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Dict, Optional

import torch

from ..core.nn import int8_matmul
from . import cuda_build, int4
from . import flash_attention as fa
from .flash_attention import (DECODE_BLOCK_CHOICES, STEP_VALUE_DIMS,
                              _check_contiguous, _check_quant_cache, _decode_blocks, _walk_blocks,
                              decode_chunk_plan)

# the default of llm.decode_step's fused_layer, as the JAX package reads it
FUSED_LAYER = os.environ.get("WALKGPT_FUSED_LAYER", "0") == "1"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 21 + [_I] * 10 + [_F, _F, _I, _I, _P]

# K12's launch plan (csrc/fused_layer.cu): TAIL_THREADS-thread blocks, at
# most TAIL_BLOCKS_PER_SM of them an SM (its registers; fewer where the
# shared memory does not fit); attention items of ATT_VALUE_DIMS value
# dims (K4's slices), o-proj items of OPROJ_COLS output columns, K6's
# gate/up and down items; rows in passes of 1, 2 or 4
TAIL_THREADS = 256
TAIL_BLOCKS_PER_SM = 2
H100_SMS = 132
H100_SMEM_PER_SM = 233472          # an SM's shared memory (228 KB)
SMEM_RESERVED = 1024               # the runtime's share of it a block
SMEM_MAX = 232448                  # the dynamic shared memory a block may have
ATT_VALUE_DIMS = STEP_VALUE_DIMS
OPROJ_COLS = 32
_OPROJ_GROUPS = OPROJ_COLS // 16
_GATE_UP_ROW_LANES = 64
_DOWN_ROW_LANES = TAIL_THREADS // 32
# the scratch's rows of [B, hd] fp32: attention rows, x2, y, hn, then h
# ([B, I] bf16) and the tiles' partials
SCRATCH_ROWS = dict(attention=0, x2=1, y=2, hn=3, h=4)


def fused_layer_tail_plan(b: int, n_kv: int, d: int, l: int, i_dim: int, pack4: bool,
                          block: Optional[int] = None, sms: int = H100_SMS) -> Dict[str, object]:
    """K12's launch for b rows, n_kv heads of d (MHA), a cache of l slots
    (key blocks of min(block, l); block None: DECODE_BLOCK at call time) and
    an intermediate of i_dim on a card of
    `sms` SMs, as csrc/fused_layer.cu takes it: the items of each phase
    (attention per (row, kv head, ATT_VALUE_DIMS value dims); o-proj,
    gate/up and down column items; the sum's TAIL_THREADS elements a
    block), the blocks an SM (TAIL_BLOCKS_PER_SM, fewer if the shared
    memory does not fit; 0: the launch fails), the grid (min(blocks an SM
    x sms, the largest phase), each block grid-strided over every phase),
    the rows per pass, the dynamic shared memory per block of each phase
    in bytes (the launch takes the largest with hn formed on the fly;
    hn_held: the gate/up phase holds hn [b, hd] in bf16 too, where that
    fits within it) and the scratch layout (rows of [b, hd] fp32). pack4
    changes neither items nor memory."""
    return _tail_plan(b, n_kv, d, l, i_dim, min(fa._switch(block, fa.DECODE_BLOCK), l), sms)


@functools.lru_cache(maxsize=None)
def _tail_plan(b: int, n_kv: int, d: int, l: int, i_dim: int, bl: int, sms: int):
    hd = n_kv * d
    mb = b if b <= 2 else 4
    tile = int4.tile_for(i_dim)
    n_tiles = i_dim // tile
    gu_offset = -(-(TAIL_THREADS + b) // 4) * 4
    smem = dict(attention=decode_chunk_plan(b, 1, n_kv, n_kv, d, bl, True,
                                            ATT_VALUE_DIMS)["smem"],
                oproj=4 * (mb * (hd // 4) + _DOWN_ROW_LANES * _OPROJ_GROUPS * mb * 16 + mb
                           + TAIL_THREADS),
                gate_up=4 * (gu_offset + max(mb * hd, 2 * _GATE_UP_ROW_LANES
                                             * (mb * int4.MLP4_GATE_UP_COLS + 4))),
                down=4 * (mb * tile + _DOWN_ROW_LANES * mb * int4.MLP4_DOWN_COLS))
    need = max(smem.values())
    with_hn = smem["gate_up"] + 4 * (-(-(b * hd // 2) // 4) * 4)     # bf16, 16-byte rounded
    held = with_hn <= need
    if held:
        smem["gate_up"] = with_hn
    per_sm = (0 if need > SMEM_MAX
              else min(TAIL_BLOCKS_PER_SM, H100_SMEM_PER_SM // (need + SMEM_RESERVED)))
    items = dict(attention=b * n_kv * -(-d // ATT_VALUE_DIMS), oproj=-(-hd // OPROJ_COLS),
                 gate_up=-(-i_dim // int4.MLP4_GATE_UP_COLS),
                 down=-(-hd // int4.MLP4_DOWN_COLS) * n_tiles, sum=-(-b * hd // TAIL_THREADS))
    h_rows = -(-i_dim // (2 * hd))
    scratch = dict(SCRATCH_ROWS, parts=SCRATCH_ROWS["h"] + h_rows,
                   rows=SCRATCH_ROWS["h"] + h_rows + n_tiles)
    return dict(items=items, blocks=min(per_sm * sms, max(items.values())), blocks_per_sm=per_sm,
                threads=TAIL_THREADS, rows_per_pass=mb, tile=tile, n_tiles=n_tiles, block=bl,
                smem_phases=smem, smem=need, hn_held=held, scratch=scratch, barriers=4)


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
                               block: Optional[int] = None,
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


def _launch(entry: str, x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask, o_p,
            post_norm_scale, mlp_p, *, n_kv: int, head_dim: int, pack4: bool, layer: int,
            act: str, norm_eps: float, block: int, valid_len: Optional[int]) -> torch.Tensor:
    """Check K12's inputs and launch the C entry `entry` on them; returns
    row 2 of the scratch (fused_layer_tail_plan's layout)."""
    _check_mha(x, n_kv, head_dim)
    name = "fused_layer_tail"
    b, hd = x.shape
    d = head_dim
    l = k_cache.shape[2]
    bl, nvb = _decode_blocks(l, block, valid_len)
    first, up, down, gelu = int4._mlp_parts(mlp_p, act)
    i_dim = first["w_p4"].shape[1]
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
    plan = fused_layer_tail_plan(b, n_kv, d, l, i_dim, pack4, bl)
    if not plan["blocks_per_sm"]:
        fits = [c for c in DECODE_BLOCK_CHOICES
                if fused_layer_tail_plan(b, n_kv, d, l, i_dim, pack4, c)["blocks_per_sm"]]
        raise ValueError(f"{name}: a block of {bl} keys at D={d} does not fit the kernel's "
                         f"shared memory; it takes blocks of {fits} keys at this shape")
    rows = plan["scratch"]
    buf = torch.empty((rows["rows"], b, hd), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.launch(
        "fused_layer", entry, _ARGTYPES, x.device,
        q8.data_ptr(), qs.data_ptr(), k_cache[layer].data_ptr(), k_scale[layer].data_ptr(),
        v_cache[layer].data_ptr(), v_scale[layer].data_ptr(), key_mask.data_ptr(),
        x.data_ptr(), o_p["w_q"].data_ptr(), o_p["w_scale"].data_ptr(),
        post_norm_scale.data_ptr(), first["w_p4"].data_ptr(), first["w_scale"].data_ptr(),
        ptr(ups[0]), ptr(ups[1]), down["w_p4t"].data_ptr(), down["w_scale"].data_ptr(),
        buf[rows["attention"]].data_ptr(), buf[rows["x2"]].data_ptr(),
        buf[rows["hn"]].data_ptr(), buf[rows["y"]].data_ptr(),
        b, n_kv, d, l, bl, nvb, int(pack4), i_dim, plan["tile"], int(gelu),
        1.0 / math.sqrt(d), norm_eps, _DTYPES[x.dtype], _DTYPES[post_norm_scale.dtype])
    return buf[rows["y"]]


def fused_layer_tail(x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask, o_p,
                     post_norm_scale, mlp_p, *, n_kv: int, head_dim: int, pack4: bool,
                     layer: int, act: str, norm_eps: float, block: Optional[int] = None,
                     valid_len: Optional[int] = None) -> torch.Tensor:
    """K12: one decode layer's tail in one launch.

    x: [B, H] the layer's input (the residual stream before the input
    norm); q8 int8 [B, n_kv, 1, D] and qs fp32 [B, n_kv, 1]: banded_q8 of
    the step's roped q; the caches and key_mask as for decode_attention_q
    (the step's K/V already written); o_p {"w_q" [H, H] int8, "w_scale" [H]
    fp32, "a8"}; post_norm_scale [H]; mlp_p {"gate", "up": {w_p4, w_scale},
    "down": {w_p4t, w_scale}} (act "silu") or {"fc1", "fc2"} (gelu);
    valid_len: whole length blocks at or past it are skipped; block: the
    walk's (None: DECODE_BLOCK at call time). Returns fp32 [B, H] = x2 +
    mlp(norm(x2)); on the card it is row 2 of the launch's
    scratch (its `_base`; fused_layer_tail_plan's layout: attention rows,
    x2, y, hn, h, the MLP tiles' partials), where a check can read the fp32
    attention rows and the other phases' outputs."""
    if x.device.type == "cpu":
        return fused_layer_tail_reference(
            x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask, o_p, post_norm_scale,
            mlp_p, n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, act=act,
            norm_eps=norm_eps, block=block, valid_len=valid_len)
    y = _launch("wg_fused_layer_tail", x, q8, qs, k_cache, k_scale, v_cache, v_scale, key_mask,
                o_p, post_norm_scale, mlp_p, n_kv=n_kv, head_dim=head_dim, pack4=pack4,
                layer=layer, act=act, norm_eps=norm_eps, block=block, valid_len=valid_len)
    fused_layer_tail.launches += 1
    return y


def fused_layer_tail_barriers(*args, **kwargs) -> torch.Tensor:
    """K12's launch on fused_layer_tail's arguments with every phase empty
    (CUDA tensors only): the launch and its four grid barriers alone, what
    tools/decode_kernels.py times as the barriers' cost. Its output is not
    written; it counts no launches."""
    if args[0].device.type != "cuda":
        raise ValueError("fused_layer_tail_barriers: CUDA tensors only")
    kwargs.setdefault("block", None)
    kwargs.setdefault("valid_len", None)
    return _launch("wg_fused_layer_tail_barriers", *args, **kwargs)


def fused_layer_tail_info(b: int, n_kv: int, d: int, l: int, i_dim: int, pack4: bool,
                          x_dtype: torch.dtype, pn_dtype: torch.dtype, device: torch.device,
                          block: Optional[int] = None) -> Dict[str, int]:
    """What K12's launch takes on `device` at these shapes, from the CUDA
    runtime (no launch): blocks, blocks an SM, SMs, registers a thread,
    dynamic shared memory a block in bytes, local (spilled) bytes a thread,
    rows per pass, whether hn is held in shared memory. block None:
    DECODE_BLOCK at call time."""
    bl = min(fa._switch(block, fa.DECODE_BLOCK), l)
    info = (ctypes.c_int * 8)()
    entry = cuda_build.entry("fused_layer", "wg_fused_layer_tail_info", [_I] * 10 + [_P])
    with torch.cuda.device(device):
        rc = entry(b, n_kv, d, l, bl, int(pack4), i_dim, int4.tile_for(i_dim), _DTYPES[x_dtype],
                   _DTYPES[pn_dtype], ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"wg_fused_layer_tail_info: CUDA error {rc}")
    return dict(zip(("blocks", "blocks_per_sm", "sms", "registers", "smem", "local_bytes",
                     "rows_per_pass", "hn_held"), list(info)))


fused_layer_tail.launches = 0

KERNELS = (fused_layer_tail,)
