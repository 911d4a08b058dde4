"""The attention kernels of the main paths, each beside its plain version.

Every public function here dispatches on the device of its inputs: a CPU
tensor runs the plain PyTorch version (`*_reference`, which the CPU tests hold
against the JAX package); a CUDA tensor launches the hand-written CUDA kernel
(csrc/, built by ops/cuda_build.py at first use) or raises. There is no
fallback from the kernel to the plain version. Each wrapper counts its
launches in a plain integer attribute, `<function>.launches`.

K1 flash_attention (csrc/flash_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:flash_attention (_fwd_kernel):
    the causal LLM prefill attention with a per-batch key mask, fp32 math.
    7B prefill [2, 32, 447, 128] bf16: about 29 MB moved and 3.3 GFLOP, so
    bound by bytes on an H100 (about 9 us at 3.35 TB/s). bf16 runs on the
    tensor cores (csrc/attention_mma.cuh: s as scale times the fp32 sum of
    exact q . k products, as K1b forms it; p split hi + lo for the value
    product; query tiles heaviest first); fp32 stays on the CUDA-core
    engine. fp16 (the LLM of `--precision fp16`) runs the same tensor-core
    engine with f16 products: q . k of two fp16 values is exact in fp32
    as for bf16, and p is split hi + lo in fp16.
K2 sam_window_attention_packed (csrc/sam_window_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:sam_window_attention_packed
    (_win_packed_fwd_kernel): whole-window attention with the decomposed
    rel-pos bias, read from the unsplit qkv projection, merged heads out.
    ViT-H, 2 images: qkv [50, 196, 3840], rel [50, 196, 448] bf16: about
    109 MB and 9.8 GFLOP, bound by bytes (about 33 us). bf16 runs on the
    tensor cores (csrc/attention_mma.cuh: the head views read in place, the
    tile's rel rows and a key -> (k / ws, k % ws) table staged in shared
    memory); fp32 stays on the CUDA-core engine.
K3 sam_flash_attention (csrc/sam_flash_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:sam_flash_attention
    (_sam_fwd_kernel): global attention over the 64x64 grid with the
    decomposed rel-pos bias built per key tile. ViT-H, 2 images:
    [2, 16, 4096, 80] bf16, about 172 GFLOP, bound by operations (about
    174 us at 989 TFLOP/s bf16). bf16 runs on the tensor cores
    (csrc/attention_mma.cuh: mma.sync products, cp.async double-buffered
    key tiles); fp32 stays on the CUDA-core engine below, which the fp32
    parity runs need (the tensor cores have no exact fp32 product).

K10 sam_window_attention (csrc/sam_window_attention_split.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:sam_window_attention
    (_win_fwd_kernel): K2's function over the split-head layout, q/k/v
    [BW, H, T, D] and rel_h/rel_w [BW, H, T, ws] (in q's dtype or fp32), on
    K2's engines (bf16 q: tensor cores; fp32: CUDA cores), so on the same
    values its output is K2's bit for bit. No model path calls it (the
    encoder's windowed blocks take K2). ViT-H, 2 images: [50, 16, 196, 80]
    bf16, about 110 MB, bound by bytes (33 us).

K1b flash_attention_bwd (csrc/flash_attention_bwd.cu), K2b
sam_window_attention_packed_bwd (csrc/sam_window_attention_bwd.cu), K3b
sam_flash_attention_bwd (csrc/sam_flash_attention_bwd.cu)
    Replace the JAX custom_vjp backwards of K1-K3 (_flash_bwd,
    _win_packed_vjp_bwd, _sam_flash_bwd). Each is launched from the
    backward of its forward's torch.autograd.Function, which saves out and
    lse (on CPU tensors the Function runs the plain forward and the plain
    backward, *_bwd_reference, which repeats the TPU backward's arithmetic).
    K10b sam_window_attention_bwd (csrc/sam_window_attention_split_bwd.cu)
    is K10's, replacing _win_vjp_bwd, on K2b's engine.
    One two-pass engine (csrc/attention_bwd.cuh): a dq pass per 64-query
    tile, which also sums K2b/K3b's rel-pos gradients, and a dk/dv pass per
    64-key tile, both recomputing p from lse; no atomics. 7B training
    [2, 32, 767, 128] bf16 (K1b): about 101 MB, bound by bytes (30 us);
    ViT-H global (K3b): about 430 GFLOP, bound by operations (434 us).
    The bf16 routes of K1b, K2b, K3b and K10b run the same two passes on
    the tensor cores (csrc/attention_mma_bwd.cuh; K1b and K3b in one
    launch, K2b and K10b in two): s and dp as bf16 products, dv, dk and dq
    with p and ds split into two bf16 parts (hi + lo, about 16 significant
    bits), deterministic as before. K1b takes the engine's pair layout (8
    warps, warps w and w + 4 splitting a tile's products, so that D = 128
    fits the registers) and forms s as scale times the fp32 sum of q . k
    (K1's function; K2b, K3b and K10b stage bf16(q * scale), SAM's). K2b
    and K10b stage the rel rows and K2's key table as the forward does and
    form drel as products of the split ds with one-hot matrices
    (window_bwd_plan mirrors their launch); K10b gives K2b's bits on
    repacked values.

K4 decode_attention_q (csrc/decode_attention_q.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q
    (_decode_attn_q8_kernel, _decode_attn_q_kernel): one decode step of GQA
    attention over the flat quantized cache (int8 rows, or packed int4 in
    global-halves order), walked in DECODE_BLOCK-key blocks. 7B, 2 rows,
    480 of 512 slots valid, packed int4: about 4.1 MB of k and v codes and
    scales below valid_len, bound by bytes (about 1.2 us). An fp16 q (the
    LLM of `--precision fp16`) takes the bf16 q's route: the TPU kernels
    quantize q from fp32 or round it to bf16, and every other rounding
    point is bf16 whatever q's type; only the output is fp16.
K8 decode_attention_q_chunk (csrc/decode_attention_q.cu + decode_chunk.cuh)
    Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q_chunk
    (_decode_attn_qc_kernel): the speculative verify, Tc tokens at once over
    the same cache, causal inside the chunk by cache_len. 7B, 2 rows, Tc =
    9, packed int4: about 3.8 MB, bound by bytes (about 1.1 us).
K11 decode_attention (csrc/decode_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention
    (_decode_attn_kernel): one decode step over the flat bf16 cache of
    LLMConfig.fused_decode. Dense 7B, 2 rows, 480 of 512 slots valid: about
    15.7 MB, bound by bytes (about 4.7 us). The bf16 cache runs
    csrc/decode_flat.cuh (decode_attention_plan: blocks per (row, kv head,
    16 query rows, 32 value dims), the cache streamed by cp.async through a
    ring of 64-key tiles), the walk's bits; the fp32 cache stays on the walk.

K4 and K8 run one engine (csrc/decode_chunk.cuh; K4 at Tc = 1 with its key
mask): a block per (row, kv head, 16 query rows, 32 value dims; K4 64 value
dims while n_rep <= 8) walks the cache in DECODE_BLOCK-key blocks with the
TPU kernels' rounding points,
int8 tensor-core scores, each block's codes staged 16 bytes a thread; the
launch plans are decode_attention_q_plan and decode_chunk_plan. K11's bf16
route runs the same split on its own engine (csrc/decode_flat.cuh). K11's
fp32 route, K12's attention phase and K4's int8 value product (pv_int8, off
on the main path) run the first engine (csrc/decode_walk.cuh: a block per
(row, kv head)), whose arithmetic per block the other two repeat, so K8's
token t is K4's output at the same position, and K4 and K11 on either
engine the same, bit for bit (decode_attention_q_walk and
decode_attention_walk run them on the walk for that check).

Design (K1-K3, csrc/attention_tile.cuh): one block per 64-row query tile
and (batch, head) or (window, head); key tiles of 64 stream through shared
memory; the logits tile and its bias live only in registers and shared
memory, with an fp32 online softmax, so no [N, N] tensor reaches device
memory — the part of each bound that is bytes is met by reading each input
once per query tile. In bf16, K1, K1b, K2, K2b, K3, K3b, K10 and K10b
run on the tensor-core engines (csrc/attention_mma.cuh,
attention_mma_bwd.cuh: the same tiles, each warp 16 rows, mma.sync bf16
products with fp32 sums, a problem object per kernel); every fp32 call
stays on the CUDA-core engines (the fp32 parity runs need exact fp32
products). wgmma/TMA tiles are later work.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Dict, Optional, Tuple

import torch

from ..core.nn import unpack4
from . import cuda_build

# the dtype codes of the C entries; K1 and K4 also take fp16 (code 2), every
# other kernel float32 or bfloat16 alone
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPES_F16 = {**_DTYPES, torch.float16: 2}
_KERNEL_DTYPES = {"flash_attention": _DTYPES_F16, "decode_attention_q": _DTYPES_F16}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    "wg_flash_attention_fwd": ("flash_attention",
                               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _F, _I, _P]),
    "wg_sam_window_attention_fwd": ("sam_window_attention",
                                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "wg_sam_flash_attention_fwd": ("sam_flash_attention",
                                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _P, _F, _I, _P]),
    "wg_decode_attention_q": ("decode_attention_q", [_P] * 7 + [_I] * 10 + [_F, _I, _P]),
    "wg_decode_attention_q_walk": ("decode_attention_q", [_P] * 7 + [_I] * 10 + [_F, _I, _P]),
    "wg_decode_attention_q_chunk": ("decode_attention_q", [_P] * 7 + [_I] * 9 + [_F, _I, _P]),
    "wg_decode_attention": ("decode_attention", [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
    "wg_decode_attention_walk": ("decode_attention", [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
    "wg_flash_attention_bwd": ("flash_attention_bwd", [_P] * 10 + [_I] * 5 + [_F, _I, _P]),
    "wg_sam_window_attention_bwd": ("sam_window_attention_bwd",
                                    [_P] * 7 + [_I] * 5 + [_F, _I, _P]),
    "wg_sam_window_delta": ("sam_window_attention_bwd", [_P] * 3 + [_I] * 3 + [_P]),
    "wg_sam_flash_attention_bwd": ("sam_flash_attention_bwd",
                                   [_P] * 13 + [_I] * 6 + [_F, _I, _P]),
    "wg_sam_window_split_fwd": ("sam_window_attention_split",
                                [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I, _P]),
    "wg_sam_window_split_bwd": ("sam_window_attention_split_bwd",
                                [_P] * 13 + [_I] * 5 + [_F, _I, _I, _P]),
}


def _check_cuda(name: str, *xs: torch.Tensor) -> int:
    dev, dt = xs[0].device, xs[0].dtype
    for x in xs:
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"{name}: all inputs must share device and dtype, "
                             f"got {[(y.device, y.dtype) for y in xs]}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    table = _KERNEL_DTYPES.get(name, _DTYPES)
    if dt not in table:
        names = [_DTYPE_NAMES[t] for t in table]
        raise ValueError(f"{name}: the kernel takes {', '.join(names[:-1])} or {names[-1]}, "
                         f"got {dt}")
    return table[dt]


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Unit stride on the last axis (other strides are passed to the kernel)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _strides(*xs: torch.Tensor):
    """The batch, head and row strides of each tensor, as a C int64 array."""
    return (ctypes.c_int64 * (3 * len(xs)))(*[s for x in xs for s in x.stride()[:3]])


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    lib, argtypes = _SIGNATURES[fn_name]
    cuda_build.launch(lib, fn_name, argtypes, dev, *args)


def _softmax_rows(s: torch.Tensor, v: torch.Tensor, p_dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """out = softmax(s) @ v, with p cast to p_dtype for the product and the
    denominator from the uncast p; lse = m + log(l). fp32 throughout."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("...qk,...kd->...qd", p.to(p_dtype).float(), v.float())
    return o / l, (m + torch.log(l))[..., 0]


def _delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(g * out) over the head dim, in fp32: plain torch beside
    every backward kernel, as in the JAX package. The products of two bf16
    values are exact in fp32, so multiplying an fp32 copy of g in place by
    out gives the same values as casting both, with one pass less."""
    return g.to(torch.float32, copy=True).mul_(out).sum(-1)


# ---------------------------------------------------------------------------
# K1 / K1b: causal prefill attention and its backward
# ---------------------------------------------------------------------------

def _k1_mask(q: torch.Tensor, causal: bool, key_valid: Optional[torch.Tensor]) -> torch.Tensor:
    b, n = q.shape[0], q.shape[2]
    mask = torch.ones((b, 1, 1, n), dtype=torch.bool, device=q.device)
    if key_valid is not None:
        mask = key_valid.bool()[:, None, None, :]
    if causal:
        pos = torch.arange(n, device=q.device)
        mask = mask & (pos[None, :] <= pos[:, None])
    return mask


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True,
                              key_valid: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1. q, k, v: [B, H, N, D]; key_valid: [B, N] bool.
    q, k, v upcast to fp32, q scaled after the upcast, masked logits -1e30.
    Returns (out [B, H, N, D] in q's dtype, lse [B, H, N] fp32)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (1.0 / math.sqrt(d)), k.float())
    s = torch.where(_k1_mask(q, causal, key_valid), s, -1e30)
    o, lse = _softmax_rows(s, v, torch.float32)
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, causal: bool, key_valid, out, lse, g
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1b, the arithmetic of the JAX _flash_bwd: q, k, v
    and g upcast to fp32; s = (q * scale) . k; p = exp(s - lse), exactly 0
    at masked positions (a fully masked row, whose s and lse are both about
    -1e30, gets no gradient); ds = p * (g . v - delta); dq = ds . k * scale,
    dk = ds^T . q * scale, dv = p^T . g, each in its input's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
    p = torch.where(_k1_mask(q, causal, key_valid), torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - _delta(g, out)[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _key_valid_u8(name: str, key_valid, b: int, n: int, dev) -> torch.Tensor:
    if key_valid is None:
        return torch.ones((b, n), dtype=torch.uint8, device=dev)
    if tuple(key_valid.shape) != (b, n):
        raise ValueError(f"{name}: key_valid must be [{b}, {n}]")
    return key_valid.to(device=dev, dtype=torch.uint8).contiguous()


def _flash_fwd(q, k, v, causal: bool, key_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, key_valid)
    dt = _check_cuda("flash_attention", q, k, v)
    b, h, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d > 128:
        raise ValueError(f"flash_attention: q, k, v must share a [B, H, N, D<=128] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    kv = _key_valid_u8("flash_attention", key_valid, b, n, q.device)
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("wg_flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, n, d, _strides(q, k, v),
            int(causal), 1.0 / math.sqrt(d), dt)
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, causal: bool, key_valid, out, lse, g
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b: (dq, dk, dv) of flash_attention for the output gradient g, from
    the forward's out and lse: a dq pass per 64-query tile and a dk/dv pass
    per 64-key tile, both recomputing p from lse (bf16: one launch of both
    on the tensor cores; fp32: two launches on the CUDA cores); the same
    bits on every run."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, causal, key_valid, out, lse, g)
    name = "flash_attention_bwd"
    dt = _check_cuda(name, q, k, v, g)
    b, h, n, d = q.shape
    if (k.shape != q.shape or v.shape != q.shape or g.shape != q.shape or d > 128
            or tuple(lse.shape) != (b, h, n)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, g {tuple(g.shape)}, lse {tuple(lse.shape)}")
    kv = _key_valid_u8(name, key_valid, b, n, q.device)
    q, k, v, g = (x.contiguous() for x in (q, k, v, g))
    lse, delta = lse.float().contiguous(), _delta(g, out).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    _launch("wg_flash_attention_bwd", q.device,
            *[x.data_ptr() for x in (q, k, v, kv, g, lse, delta, dq, dk, dv)],
            b, h, n, d, int(causal), 1.0 / math.sqrt(d), dt)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K1b backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, key_valid):
        out, lse = _flash_fwd(q, k, v, causal, key_valid)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, ctx.causal, key_valid, out, lse, g), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, key_valid: Optional[torch.Tensor] = None,
                    *, return_lse: bool = False):
    """K1: self-attention over [B, H, N, D] with an optional causal mask and
    key mask key_valid [B, N] (True = attend). Returns out [B, H, N, D]
    (and lse [B, H, N] fp32, not differentiable, when return_lse).
    Differentiable in q, k and v: the backward is K1b."""
    out, lse = _FlashAttention.apply(q, k, v, causal, key_valid)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K2 / K2b: packed windowed attention (SAM ViT windowed blocks) and its backward
# ---------------------------------------------------------------------------

def _win_heads(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[BW, T, H*w] lanes -> [BW, H, T, w]."""
    return x.reshape(x.shape[0], x.shape[1], h, w).transpose(1, 2)


def _win_merge(x: torch.Tensor) -> torch.Tensor:
    """[BW, H, T, w] -> [BW, T, H*w] lanes."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)


def _win_split_logits(q, k, rel_h, rel_w, ws: int) -> torch.Tensor:
    """s [BW, H, T, T] fp32 with the bias, from the split layout: q*scale
    rounded to q's dtype before the product, bias rel_h[k // ws] +
    rel_w[k % ws] formed in fp32. The plain versions of K2 and K10 both
    take their logits here."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    key = torch.arange(q.shape[2], device=q.device)
    return s + (rel_h.float()[..., key // ws] + rel_w.float()[..., key % ws])


def _win_split_heads(qkv, rel, h: int, d: int, ws: int):
    """K2's packed layout -> K10's split one: (q, k, v [BW, H, T, D],
    rel_h, rel_w [BW, H, T, ws])."""
    c = h * d
    q, k, v = (_win_heads(qkv[..., i * c:(i + 1) * c], h, d) for i in range(3))
    return q, k, v, _win_heads(rel[..., :h * ws], h, ws), _win_heads(rel[..., h * ws:], h, ws)


def sam_window_attention_packed_reference(qkv: torch.Tensor, rel: torch.Tensor,
                                          num_heads: int, head_dim: int, window: int
                                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: K10's plain version on the heads split out of
    the packed layout. qkv [BW, T, 3*H*D], rel [BW, T, 2*H*ws]. Returns
    (out [BW, T, H*D] in qkv's dtype, lse [BW, T, H] fp32)."""
    o, lse = sam_window_attention_reference(
        *_win_split_heads(qkv, rel, num_heads, head_dim, window), window)
    return _win_merge(o), lse.transpose(1, 2)


def sam_window_attention_packed_bwd_reference(qkv, rel, num_heads: int, head_dim: int,
                                              window: int, out, lse, g
                                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2b, the arithmetic of the JAX _win_packed_bwd_kernel,
    which is K10b's (sam_window_attention_bwd_reference) on the heads split
    out of the packed layouts. Returns (dqkv [BW, T, 3*H*D], drel [BW, T,
    2*H*ws]) in the inputs' dtypes."""
    h, d, ws = num_heads, head_dim, window
    grads = sam_window_attention_bwd_reference(
        *_win_split_heads(qkv, rel, h, d, ws), ws, _win_heads(out, h, d),
        lse.transpose(1, 2), _win_heads(g, h, d))
    return (torch.cat([_win_merge(x) for x in grads[:3]], dim=-1),
            torch.cat([_win_merge(x) for x in grads[3:]], dim=-1))


def _window_delta(name: str, g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """_delta on the card for K2b and K10b: g and out [..., D] of one shape
    and dtype (contiguous after the call) -> delta [...] fp32, by one launch
    of csrc/sam_window_attention_bwd.cu's row_dot_kernel (fp32 sums of the
    exact products, in another order than _delta's)."""
    if out.shape != g.shape or out.dtype != g.dtype or out.device != g.device:
        raise ValueError(f"{name}: bad out {out.dtype} {tuple(out.shape)} for g "
                         f"{g.dtype} {tuple(g.shape)}")
    g, out = g.contiguous(), out.contiguous()
    delta = torch.empty(g.shape[:-1], dtype=torch.float32, device=g.device)
    _launch("wg_sam_window_delta", g.device, g.data_ptr(), out.data_ptr(), delta.data_ptr(),
            delta.numel(), g.shape[-1], _DTYPES[g.dtype])
    return delta


def _check_window(name: str, qkv, rel, h: int, d: int, ws: int) -> None:
    bw, t, _ = qkv.shape
    if (t != ws * ws or qkv.shape[-1] != 3 * h * d or tuple(rel.shape) != (bw, t, 2 * h * ws)
            or d > 128):
        raise ValueError(f"{name}: bad shapes qkv {tuple(qkv.shape)}, "
                         f"rel {tuple(rel.shape)} for H={h}, D={d}, ws={ws}")


def _window_fwd(qkv, rel, h: int, d: int, ws: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if qkv.device.type == "cpu":
        return sam_window_attention_packed_reference(qkv, rel, h, d, ws)
    dt = _check_cuda("sam_window_attention_packed", qkv, rel)
    _check_window("sam_window_attention_packed", qkv, rel, h, d, ws)
    bw, t, _ = qkv.shape
    qkv, rel = qkv.contiguous(), rel.contiguous()
    out = torch.empty((bw, t, h * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((bw, t, h), dtype=torch.float32, device=qkv.device)
    _launch("wg_sam_window_attention_fwd", qkv.device,
            qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bw, t, h, d, ws, 1.0 / math.sqrt(d), dt)
    sam_window_attention_packed.launches += 1
    return out, lse


def sam_window_attention_packed_bwd(qkv, rel, num_heads: int, head_dim: int, window: int,
                                    out, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b: (dqkv [BW, T, 3*H*D], drel [BW, T, 2*H*ws]) of
    sam_window_attention_packed for the output gradient g [BW, T, H*D], in
    the packed layouts: a dq + drel pass over 64-query tiles, then a dk/dv
    pass over 64-key tiles of each (window, head), two launches, on the
    tensor cores for bf16, on the CUDA cores for fp32."""
    h, d, ws = num_heads, head_dim, window
    if qkv.device.type == "cpu":
        return sam_window_attention_packed_bwd_reference(qkv, rel, h, d, ws, out, lse, g)
    name = "sam_window_attention_packed_bwd"
    dt = _check_cuda(name, qkv, rel, g)
    _check_window(name, qkv, rel, h, d, ws)
    bw, t, _ = qkv.shape
    if tuple(g.shape) != (bw, t, h * d) or tuple(lse.shape) != (bw, t, h):
        raise ValueError(f"{name}: bad g {tuple(g.shape)} or lse {tuple(lse.shape)}")
    qkv, rel, g = qkv.contiguous(), rel.contiguous(), g.contiguous()
    lse = lse.float().contiguous()
    delta = _window_delta(name, g.reshape(bw, t, h, d), out.reshape(bw, t, h, d))
    dqkv, drel = torch.empty_like(qkv), torch.empty_like(rel)
    _launch("wg_sam_window_attention_bwd", qkv.device,
            *[x.data_ptr() for x in (qkv, rel, g, lse, delta, dqkv, drel)],
            bw, t, h, d, ws, 1.0 / math.sqrt(d), dt)
    sam_window_attention_packed_bwd.launches += 1
    return dqkv, drel


sam_window_attention_packed_bwd.launches = 0


class _SamWindowAttention(torch.autograd.Function):
    """K2 forward, K2b backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, qkv, rel, h, d, ws):
        out, lse = _window_fwd(qkv, rel, h, d, ws)
        ctx.dims = (h, d, ws)
        ctx.save_for_backward(qkv, rel, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        qkv, rel, out, lse = ctx.saved_tensors
        return (*sam_window_attention_packed_bwd(qkv, rel, *ctx.dims, out, lse, g),
                None, None, None)


def sam_window_attention_packed(qkv: torch.Tensor, rel: torch.Tensor, num_heads: int,
                                head_dim: int, window: int, *, return_lse: bool = False):
    """K2: whole-window attention with decomposed rel-pos bias over the packed
    layout. qkv: [BW, T, 3*H*D] unsplit; rel: [BW, T, 2*H*ws], lanes
    [h*ws:(h+1)*ws] = rel_h of head h, [(H+h)*ws:...] = rel_w. Returns merged
    heads [BW, T, H*D] (and lse [BW, T, H] fp32 when return_lse).
    Differentiable in qkv and rel: the backward is K2b."""
    out, lse = _SamWindowAttention.apply(qkv, rel, num_heads, head_dim, window)
    return (out, lse) if return_lse else out


sam_window_attention_packed.launches = 0


# ---------------------------------------------------------------------------
# K10 / K10b: windowed attention over the split-head layout and its backward
# ---------------------------------------------------------------------------

def sam_window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   rel_h: torch.Tensor, rel_w: torch.Tensor, window: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10 (the JAX _win_fwd_kernel). q, k, v [BW, H, T,
    D] with T = window**2; rel_h, rel_w [BW, H, T, window] in q's dtype or
    fp32. Returns (out [BW, H, T, D] in q's dtype, lse [BW, H, T] fp32)."""
    s = _win_split_logits(q, k, rel_h, rel_w, window)
    o, lse = _softmax_rows(s, v, v.dtype)
    return o.to(q.dtype), lse


def sam_window_attention_bwd_reference(q, k, v, rel_h, rel_w, window: int, out, lse, g):
    """Plain version of K10b, the arithmetic of the JAX _win_bwd_kernel: s
    formed as the forward forms it, p = exp(s - lse) in fp32 (the forward
    rounds p for its value product; this does not), ds = p * (g . v -
    delta); dq = ds . k * scale, dk = ds^T . q * scale (q unscaled, fp32),
    dv = p^T . g; drel_h[q, r] = sum of ds over the keys of window row r,
    drel_w[q, c] over window column c. Returns (dq, dk, dv, drel_h,
    drel_w) in the inputs' dtypes."""
    ws = window
    p = torch.exp(_win_split_logits(q, k, rel_h, rel_w, ws) - lse[..., None])
    gf = g.float()
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, v.float()) - _delta(g, out)[..., None])
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    ds5 = ds.reshape(*ds.shape[:3], ws, ws)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds5.sum(-1).to(rel_h.dtype),
            ds5.sum(-2).to(rel_w.dtype))


def _check_split_window(name: str, q, k, v, rel_h, rel_w, ws: int) -> int:
    """Shapes, devices and the rel tables' dtype (q's, or fp32) of K10 /
    K10b; returns the rel dtype's code."""
    bw, h, t, d = q.shape
    if (t != ws * ws or k.shape != q.shape or v.shape != q.shape or d > 128
            or tuple(rel_h.shape) != (bw, h, t, ws) or rel_w.shape != rel_h.shape):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, rel_h {tuple(rel_h.shape)}, "
                         f"rel_w {tuple(rel_w.shape)} for window {ws}")
    if (rel_h.device != q.device or rel_w.device != q.device or rel_w.dtype != rel_h.dtype
            or rel_h.dtype not in (q.dtype, torch.float32)):
        raise ValueError(f"{name}: rel_h and rel_w must lie on q's device in q's dtype or "
                         f"float32, got {rel_h.device} {rel_h.dtype}, {rel_w.device} "
                         f"{rel_w.dtype} for q {q.device} {q.dtype}")
    return _DTYPES[rel_h.dtype]


def _window_split_fwd(q, k, v, rel_h, rel_w, ws: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return sam_window_attention_reference(q, k, v, rel_h, rel_w, ws)
    name = "sam_window_attention"
    dt = _check_cuda(name, q, k, v)
    rdt = _check_split_window(name, q, k, v, rel_h, rel_w, ws)
    bw, h, t, d = q.shape
    q, k, v = _rows(q), _rows(k), _rows(v)
    rel_h, rel_w = rel_h.contiguous(), rel_w.contiguous()
    out = torch.empty((bw, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bw, h, t), dtype=torch.float32, device=q.device)
    _launch("wg_sam_window_split_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bw, h, t, d, ws, _strides(q, k, v),
            1.0 / math.sqrt(d), dt, rdt)
    sam_window_attention.launches += 1
    return out, lse


def sam_window_attention_bwd(q, k, v, rel_h, rel_w, window: int, out, lse, g):
    """K10b: (dq, dk, dv, drel_h, drel_w) of sam_window_attention for the
    output gradient g, from the forward's out and lse: a dq pass per
    64-query tile that also sums drel_h and drel_w, and a dk/dv pass per
    64-key tile of each (window, head), two launches on K2b's engines
    (bf16 q: the tensor cores, with bf16 or fp32 rel tables; fp32: the
    CUDA cores)."""
    ws = window
    if q.device.type == "cpu":
        return sam_window_attention_bwd_reference(q, k, v, rel_h, rel_w, ws, out, lse, g)
    name = "sam_window_attention_bwd"
    dt = _check_cuda(name, q, k, v, g)
    rdt = _check_split_window(name, q, k, v, rel_h, rel_w, ws)
    bw, h, t, d = q.shape
    if g.shape != q.shape or tuple(lse.shape) != (bw, h, t):
        raise ValueError(f"{name}: bad g {tuple(g.shape)} or lse {tuple(lse.shape)}")
    q, k, v, g, rel_h, rel_w = (x.contiguous() for x in (q, k, v, g, rel_h, rel_w))
    lse, delta = lse.float().contiguous(), _window_delta(name, g, out)
    grads = [torch.empty_like(x) for x in (q, k, v, rel_h, rel_w)]
    _launch("wg_sam_window_split_bwd", q.device,
            *[x.data_ptr() for x in (q, k, v, rel_h, rel_w, g, lse, delta, *grads)],
            bw, h, t, d, ws, 1.0 / math.sqrt(d), dt, rdt)
    sam_window_attention_bwd.launches += 1
    return tuple(grads)


sam_window_attention_bwd.launches = 0


class _SamWindowSplit(torch.autograd.Function):
    """K10 forward, K10b backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, window):
        out, lse = _window_split_fwd(q, k, v, rel_h, rel_w, window)
        ctx.window = window
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        return (*sam_window_attention_bwd(q, k, v, rel_h, rel_w, ctx.window, out, lse, g),
                None)


def sam_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor, window: int, *,
                         return_lse: bool = False):
    """K10: whole-window attention with the decomposed rel-pos bias over the
    split-head layout (K2's function, heads split out). q/k/v: [BW, H, T,
    D] with BW = batch * windows and T = window**2; rel_h, rel_w: [BW, H,
    T, window], the per-axis rel-pos projections, in q's dtype or fp32.
    Zero-padded window tokens are attended, as in the reference. Returns
    out [BW, H, T, D] (and lse [BW, H, T] fp32 when return_lse).
    Differentiable in q, k, v, rel_h and rel_w: the backward is K10b. No
    model path calls it: the encoder's windowed blocks take K2."""
    out, lse = _SamWindowSplit.apply(q, k, v, rel_h, rel_w, int(window))
    return (out, lse) if return_lse else out


sam_window_attention.launches = 0


# the bf16 backward engine's tiles (csrc/attention_mma_bwd.cuh, the 4-warp
# layout): BWD_TILE rows a block's own tile and a streamed tile,
# BWD_WARP_ROWS rows a warp; grids of at most BWD_ONE_HOT rows and columns
# take the one-hot rel-gradient path
BWD_TILE, BWD_WARP_ROWS, BWD_ONE_HOT = 64, 16, 16


def window_bwd_plan(t: int, ws: int) -> Dict[str, list]:
    """The bf16 route of K2b and K10b over one (window, head) of T = ws^2
    tokens, as csrc/attention_mma_bwd.cuh runs it (a dq block per query
    tile, then a dk/dv block per key tile). Returns
      "products": the (rows, columns) ranges each warp multiplies against
          each streamed tile, the same for both passes (N == NK): the dq
          pass's rows are queries and columns keys, the dk/dv pass's the
          other way round. A warp whose rows all lie past T forms none; a
          streamed tile runs whole (its rows past T are zeros);
      "drel_h", "drel_w": the dq pass's rel-gradient terms in the order the
          kernel adds them to each query's accumulators, (grid row or
          column, the keys summed into it at once): ws == 64 keeps them in
          registers (key tile kt is grid row kt); ws <= 16 takes the
          one-hot products, one step of 16 keys at a time; any other ws the
          general path, a warp's ds block summed from shared memory, one
          key tile at a time. A grid row that a step or tile boundary cuts
          is summed in parts."""
    n, g = -(-t // BWD_TILE), BWD_WARP_ROWS
    plan = {"products": [], "drel_h": [], "drel_w": []}
    for own in range(n):
        o0 = own * BWD_TILE
        for w in range(BWD_TILE // g):
            if w * g < t - o0:
                plan["products"] += [(range(o0 + w * g, o0 + (w + 1) * g),
                                      range(st * BWD_TILE, (st + 1) * BWD_TILE))
                                     for st in range(n)]
    if ws == BWD_TILE:
        for st in range(n):
            k0 = st * BWD_TILE
            plan["drel_h"].append((st, list(range(k0, k0 + BWD_TILE))))
            plan["drel_w"] += [(c, [k0 + c]) for c in range(BWD_TILE)]
        return plan
    step = g if ws <= BWD_ONE_HOT else BWD_TILE
    for k0 in range(0, t, step):
        keys = range(k0, min(k0 + step, t))
        for rr in sorted({k // ws for k in keys}):
            plan["drel_h"].append((rr, [k for k in keys if k // ws == rr]))
        for c in sorted({k % ws for k in keys}, key=lambda c: (c - k0) % ws):
            plan["drel_w"].append((c, [k for k in keys if k % ws == c]))
    return plan


# ---------------------------------------------------------------------------
# K3 / K3b: global attention with decomposed rel-pos bias (SAM ViT global
# blocks) and its backward
# ---------------------------------------------------------------------------

def _sam_logits(q, k, rel_h, rel_w, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """s [B, H, N, N] fp32: (q * scale rounded to q's dtype) . k, then
    (s + rel_w[k % gw]) + rel_h[k // gw]."""
    gh, gw = grid_hw
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    key = torch.arange(q.shape[2], device=q.device)
    return (s + rel_w.float()[..., key % gw]) + rel_h.float()[..., key // gw]


def sam_flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  rel_h: torch.Tensor, rel_w: torch.Tensor,
                                  grid_hw: Tuple[int, int]
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3. q/k/v [B, H, N, D], N = gh*gw; rel_h [B, H, N, gh];
    rel_w [B, H, N, gw]. Materialises the [B, H, N, N] logits (fp32).
    Returns (out [B, H, N, D] in q's dtype, lse [B, H, N] fp32)."""
    o, lse = _softmax_rows(_sam_logits(q, k, rel_h, rel_w, grid_hw), v, q.dtype)
    return o.to(q.dtype), lse


def sam_flash_attention_bwd_reference(q, k, v, rel_h, rel_w, grid_hw: Tuple[int, int],
                                      out, lse, g):
    """Plain version of K3b, the arithmetic of the JAX _sam_dq_kernel and
    _sam_dkv_kernel: s formed as the forward forms it, p = exp(s - lse) in
    fp32, ds = p * (g . v - delta); dq = ds . k * scale, dk = ds^T . q *
    scale, dv = p^T . g; drel_h[q, r] = sum of ds over the keys of grid row
    r, drel_w[q, c] over grid column c. Returns (dq, dk, dv, drel_h,
    drel_w) in the inputs' dtypes."""
    gh, gw = grid_hw
    p = torch.exp(_sam_logits(q, k, rel_h, rel_w, grid_hw) - lse[..., None])
    gf = g.float()
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, v.float()) - _delta(g, out)[..., None])
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    ds5 = ds.reshape(*ds.shape[:3], gh, gw)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds5.sum(-1).to(rel_h.dtype),
            ds5.sum(-2).to(rel_w.dtype))


def _check_global(name: str, q, k, v, rel_h, rel_w, grid_hw) -> None:
    b, h, n, d = q.shape
    gh, gw = grid_hw
    if (n != gh * gw or k.shape != q.shape or v.shape != q.shape or d > 128
            or tuple(rel_h.shape) != (b, h, n, gh) or tuple(rel_w.shape) != (b, h, n, gw)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, "
                         f"rel_h {tuple(rel_h.shape)}, rel_w {tuple(rel_w.shape)}, "
                         f"grid {grid_hw}")


def _sam_fwd(q, k, v, rel_h, rel_w, grid_hw) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3. q, k, v may be strided head views (unit stride on D): the kernel
    takes any batch, head and row stride, and where a row does not start
    16-byte aligned (or D % 8 != 0) it loads with 2-byte loads; no copy is
    made."""
    if q.device.type == "cpu":
        return sam_flash_attention_reference(q, k, v, rel_h, rel_w, grid_hw)
    dt = _check_cuda("sam_flash_attention", q, k, v, rel_h, rel_w)
    _check_global("sam_flash_attention", q, k, v, rel_h, rel_w, grid_hw)
    b, h, n, d = q.shape
    gh, gw = grid_hw
    q, k, v = _rows(q), _rows(k), _rows(v)
    rel_h, rel_w = rel_h.contiguous(), rel_w.contiguous()
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("wg_sam_flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, n, d, gh, gw, _strides(q, k, v),
            1.0 / math.sqrt(d), dt)
    sam_flash_attention.launches += 1
    return out, lse


def sam_flash_attention_bwd(q, k, v, rel_h, rel_w, grid_hw: Tuple[int, int], out, lse, g):
    """K3b: (dq, dk, dv, drel_h, drel_w) of sam_flash_attention for the
    output gradient g. Two passes: a dq pass per 64-query tile that also
    sums drel_h and drel_w, and a dk/dv pass per 64-key tile (bf16: one
    launch of both on the tensor cores; fp32: two launches on the CUDA
    cores); the same bits on every run."""
    if q.device.type == "cpu":
        return sam_flash_attention_bwd_reference(q, k, v, rel_h, rel_w, grid_hw, out, lse, g)
    name = "sam_flash_attention_bwd"
    dt = _check_cuda(name, q, k, v, rel_h, rel_w, g)
    _check_global(name, q, k, v, rel_h, rel_w, grid_hw)
    b, h, n, d = q.shape
    gh, gw = grid_hw
    if g.shape != q.shape or tuple(lse.shape) != (b, h, n):
        raise ValueError(f"{name}: bad g {tuple(g.shape)} or lse {tuple(lse.shape)}")
    q, k, v, g, rel_h, rel_w = (x.contiguous() for x in (q, k, v, g, rel_h, rel_w))
    lse, delta = lse.float().contiguous(), _delta(g, out).contiguous()
    grads = [torch.empty_like(x) for x in (q, k, v, rel_h, rel_w)]
    _launch("wg_sam_flash_attention_bwd", q.device,
            *[x.data_ptr() for x in (q, k, v, rel_h, rel_w, g, lse, delta, *grads)],
            b, h, n, d, gh, gw, 1.0 / math.sqrt(d), dt)
    sam_flash_attention_bwd.launches += 1
    return tuple(grads)


sam_flash_attention_bwd.launches = 0


class _SamFlashAttention(torch.autograd.Function):
    """K3 forward, K3b backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, grid_hw):
        out, lse = _sam_fwd(q, k, v, rel_h, rel_w, grid_hw)
        ctx.grid_hw = grid_hw
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        return (*sam_flash_attention_bwd(q, k, v, rel_h, rel_w, ctx.grid_hw, out, lse, g),
                None)


def sam_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_h: torch.Tensor, rel_w: torch.Tensor,
                        grid_hw: Tuple[int, int], *, return_lse: bool = False):
    """K3: SAM global attention with decomposed rel-pos bias.
    q/k/v: [B, H, N, D] with N = gh*gw; rel_h: [B, H, N, gh]; rel_w:
    [B, H, N, gw] (the per-axis projections of q on the rel-pos tables).
    Returns out [B, H, N, D] (and lse [B, H, N] fp32 when return_lse).
    Differentiable in q, k, v, rel_h and rel_w: the backward is K3b."""
    out, lse = _SamFlashAttention.apply(q, k, v, rel_h, rel_w, tuple(grid_hw))
    return (out, lse) if return_lse else out


sam_flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K4, K8, K11: decode attention over the flat caches
# ---------------------------------------------------------------------------

# The JAX package's decode switches, read from the environment at import
# with its names and defaults; the decode-attention wrappers (K4, K8, K11)
# and their callers read these module constants at call time.
# DECODE_BLOCK: the length-block size of the decode-attention walk. It is
# part of the numerics (alpha and p are rounded to bf16 per block), and
# callers round the cache length up to a multiple of it (runtime/generate.py,
# runtime/serving.py).
DECODE_BLOCK = int(os.environ.get("WALKGPT_DECODE_BLOCK", "256"))
# DECODE_QDOT8: K4's and K8's int8 scores product on per-head-quantized q
# (else the bf16 q's product); DECODE_PVDOT8: K4's int8 value product.
DECODE_QDOT8 = os.environ.get("WALKGPT_QDOT8", "1") == "1"
DECODE_PVDOT8 = os.environ.get("WALKGPT_PVDOT8", "0") == "1"
# the blocks a decode-attention kernel is asked about when one does not fit
DECODE_BLOCK_CHOICES = (64, 128, 256, 512, 1024)
NEG_INF = -1e30


def _switch(value, default):
    """A decode switch given by the caller, or the module constant's value
    at call time."""
    return default if value is None else value


def _check_block(name: str, bl: int, d: int, smem) -> None:
    """Raise ValueError, naming the blocks that fit, when a block of bl keys
    does not fit the kernel's shared memory (smem(block) -> bytes a block)."""
    if smem(bl) <= _SMEM_MAX:
        return
    fits = [c for c in DECODE_BLOCK_CHOICES if smem(c) <= _SMEM_MAX]
    raise ValueError(f"{name}: a block of {bl} keys at D={d} does not fit the kernel's "
                     f"shared memory; it takes blocks of {fits} keys at this shape")


def banded_q8_chunk(q: torch.Tensor, *, n_kv: int, head_dim: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-(token, head) quantization of q for the int8 scores product
    (the plain math of the JAX banded_q8_chunk, without the TPU's band
    matrices): qs = max(|q|max, 1e-20) * (1/127), q8 = round(q / qs).
    q [B, Tc, H*D] -> (q8 int8 [B, Tc, n_kv, n_rep, D], qs f32 [B, Tc, n_kv,
    n_rep]), query head kv*n_rep + r at [..., kv, r]."""
    b, tc, hd = q.shape
    qf = q.float().reshape(b, tc, n_kv, hd // head_dim // n_kv, head_dim)
    qs = qf.abs().amax(-1, keepdim=True).clamp_min(1e-20) * (1.0 / 127.0)
    return torch.round(qf / qs).to(torch.int8), qs[..., 0]


def banded_q8(q: torch.Tensor, *, n_kv: int, head_dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """banded_q8_chunk of one token: q [B, H*D] -> (q8 int8 [B, n_kv, n_rep,
    D], qs f32 [B, n_kv, n_rep])."""
    q8, qs = banded_q8_chunk(q[:, None], n_kv=n_kv, head_dim=head_dim)
    return q8[:, 0], qs[:, 0]


def banded_q_chunk(q: torch.Tensor, *, n_kv: int, head_dim: int) -> torch.Tensor:
    """The bf16 query of the scores product without qdot_int8 (the plain math
    of the JAX banded_q_chunk): q [B, Tc, H*D] -> bf16 [B, Tc, n_kv, n_rep, D]."""
    b, tc, hd = q.shape
    return q.to(torch.bfloat16).reshape(b, tc, n_kv, hd // head_dim // n_kv, head_dim)


def _cache_rows(c: torch.Tensor, n_kv: int, d: int, pack4: bool) -> torch.Tensor:
    """One layer's cache values [B, L, width] -> int values [B, L, n_kv, D]
    (fp32). Packed bytes hold flat dims (j, j + kd/2): lo plane, hi plane."""
    if pack4:
        c = torch.cat(unpack4(c, torch.float32), dim=-1)
    return c.float().reshape(*c.shape[:2], n_kv, d)


def _decode_blocks(l: int, block: Optional[int], valid_len: Optional[int]) -> Tuple[int, int]:
    """(keys a block, blocks to visit) of a cache of l slots: blocks of
    min(block, l) keys (block None: DECODE_BLOCK), those below valid_len."""
    bl = min(_switch(block, DECODE_BLOCK), l)
    if l % bl:
        raise ValueError(f"decode attention: cache length {l} is not a multiple of {bl}")
    nvb = l // bl if valid_len is None else min(-(-int(valid_len) // bl), l // bl)
    return bl, nvb


def _quant_walk(q, k_cache, k_scale, v_cache, v_scale, valid, nvb: int, *, n_kv: int,
                head_dim: int, pack4: bool, layer: int, bl: int, qdot_int8: bool,
                pv_int8: bool = False) -> torch.Tensor:
    """The block walk of K4 and K8 (plain) for q [B, T, H*D]: the scores
    take int q8.k times ks * (qs * scale) (banded_q8_chunk's codes), or bf16
    q.k times ks * scale; then _walk_blocks. Returns [B, T, H*D] in q's
    dtype."""
    b, tq, hd = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    if qdot_int8:
        q8, qs = banded_q8_chunk(q, n_kv=n_kv, head_dim=head_dim)
        qk, q_scale = q8.float(), (qs * scale)[..., None]         # [B, T, n_kv, n_rep, 1]
    else:
        qk, q_scale = banded_q_chunk(q, n_kv=n_kv, head_dim=head_dim).float(), scale
    out = _walk_blocks(qk, q_scale, k_cache, k_scale, v_cache, v_scale, valid, nvb,
                       pack4=pack4, layer=layer, bl=bl, pv_int8=pv_int8 and qdot_int8)
    return out.reshape(b, tq, hd).to(q.dtype)


def _walk_blocks(qk, q_scale, k_cache, k_scale, v_cache, v_scale, valid, nvb: int, *,
                 pack4: bool, layer: int, bl: int, pv_int8: bool = False) -> torch.Tensor:
    """The walk in order over the first nvb blocks of `bl` keys: per block,
    scores qk.k times ks * q_scale, logits of invalid keys -1e30, the
    running max, alpha = exp(m_old - m_new), l updated with the unrounded
    alpha, p*vs rounded to bf16 for the value product (or, with pv_int8,
    quantized per query row per block), acc scaled by bf16(alpha); at the
    end acc / bf16(l). qk [B, T, n_kv, n_rep, D] fp32 (q's codes or bf16
    values); q_scale broadcasting to [B, T, n_kv, n_rep, 1]; valid(keys) ->
    bool [B, T, len(keys)]. A block with no valid key for a query row
    leaves its state exactly as it was. Returns fp32 [B, T, n_kv, n_rep, D]."""
    b, tq, n_kv, n_rep, d = qk.shape
    dev = qk.device
    k = _cache_rows(k_cache[layer], n_kv, d, pack4)              # [B, L, n_kv, D]
    v = _cache_rows(v_cache[layer], n_kv, d, pack4)
    ks = k_scale[layer].float()[:, None, :, None]                 # [B, 1, n_kv, 1, L]
    vs = v_scale[layer].float()[:, None, :, None]
    m = torch.full((b, tq, n_kv, n_rep), NEG_INF, device=dev)
    lsum = torch.zeros((b, tq, n_kv, n_rep), device=dev)
    acc = torch.zeros((b, tq, n_kv, n_rep, d), device=dev)
    for jb in range(nvb):
        keys = slice(jb * bl, (jb + 1) * bl)
        ok = valid(keys)[:, :, None, None, :]                     # [B, T, 1, 1, bl]
        s = torch.einsum("btkrd,blkd->btkrl", qk, k[:, keys])
        s = torch.where(ok, s * (ks[..., keys] * q_scale), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        lsum = lsum * alpha + p.sum(-1)
        m = m_new
        pv = p * vs[..., keys]
        if pv_int8:
            psc = pv.amax(-1).clamp_min(1e-20) * (1.0 / 127.0)
            y = torch.einsum("btkrl,blkd->btkrd", torch.round(pv / psc[..., None]),
                             v[:, keys]) * psc[..., None]
        else:
            y = torch.einsum("btkrl,blkd->btkrd", pv.to(torch.bfloat16).float(), v[:, keys])
        acc = acc * alpha.to(torch.bfloat16).float()[..., None] + y
    return acc / lsum.to(torch.bfloat16).float().clamp_min(1e-30)[..., None]


def _check_quant_cache(name: str, b: int, n_kv: int, d: int, l: int, pack4: bool,
                       k_cache, k_scale, v_cache, v_scale) -> None:
    _, cb, _, width = k_cache.shape
    kd = n_kv * d
    if (cb != b or width != (kd // 2 if pack4 else kd) or (pack4 and kd % 2)
            or v_cache.shape != k_cache.shape or k_cache.dtype != torch.int8
            or v_cache.dtype != torch.int8
            or k_scale.shape != (k_cache.shape[0], b, n_kv, l) or v_scale.shape != k_scale.shape
            or k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16):
        raise ValueError(f"{name}: bad cache {tuple(k_cache.shape)} {k_cache.dtype}, scales "
                         f"{tuple(k_scale.shape)} {k_scale.dtype} for B={b}, n_kv={n_kv}, "
                         f"D={d}, pack4={pack4}")


def _check_contiguous(name: str, dev: torch.device, *bufs: torch.Tensor) -> None:
    if any(x.device != dev or not x.is_contiguous() for x in bufs):
        raise ValueError(f"{name}: inputs must be contiguous on one device")


def decode_attention_q_reference(q, k_cache, k_scale, v_cache, v_scale, key_mask, *,
                                 n_kv: int, head_dim: int, pack4: bool = False,
                                 layer: int = 0, block: Optional[int] = None,
                                 valid_len: Optional[int] = None,
                                 qdot_int8: Optional[bool] = None,
                                 pv_int8: Optional[bool] = None) -> torch.Tensor:
    """Plain version of K4: the block walk of _quant_walk for one token over
    the key mask; blocks at or past ceil(valid_len / block) are skipped.
    pv_int8 applies with qdot_int8 only, as in the TPU kernels; None reads
    DECODE_QDOT8 / DECODE_PVDOT8."""
    qdot_int8 = _switch(qdot_int8, DECODE_QDOT8)
    pv_int8 = _switch(pv_int8, DECODE_PVDOT8)
    bl, nvb = _decode_blocks(k_cache.shape[2], block, valid_len)
    return _quant_walk(q[:, None], k_cache, k_scale, v_cache, v_scale,
                       lambda keys: key_mask[:, None, keys], nvb, n_kv=n_kv,
                       head_dim=head_dim, pack4=pack4, layer=layer, bl=bl,
                       qdot_int8=qdot_int8, pv_int8=pv_int8)[:, 0]


def _decode_q(entry: str, q, k_cache, k_scale, v_cache, v_scale, key_mask, *, n_kv: int,
              head_dim: int, pack4: bool, layer: int, block: int, valid_len: Optional[int],
              qdot_int8: bool, pv_int8: bool) -> torch.Tensor:
    """K4's launch through the C entry `entry` (the wrapper's, or the walk's)."""
    name = "decode_attention_q"
    dt = _check_cuda(name, q)
    b, hd = q.shape
    d = head_dim
    h = hd // d
    l = k_cache.shape[2]
    bl, nvb = _decode_blocks(l, block, valid_len)
    if (hd % d or h % n_kv or tuple(key_mask.shape) != (b, l)
            or key_mask.dtype != torch.bool):
        raise ValueError(f"{name}: bad q {tuple(q.shape)} or mask {tuple(key_mask.shape)} "
                         f"{key_mask.dtype} for n_kv={n_kv}, D={d}")
    _check_quant_cache(name, b, n_kv, d, l, pack4, k_cache, k_scale, v_cache, v_scale)
    walk = entry == "wg_decode_attention_q_walk" or (qdot_int8 and pv_int8)
    _check_block(name, bl, d, lambda c: decode_attention_q_plan(
        b, h, n_kv, d, c, qdot_int8, pv_int8, walk)["smem"])
    bufs = [q, k_cache[layer], k_scale[layer], v_cache[layer], v_scale[layer], key_mask]
    _check_contiguous(name, q.device, *bufs)
    out = torch.empty((b, hd), dtype=q.dtype, device=q.device)
    _launch(entry, q.device, *[x.data_ptr() for x in bufs], out.data_ptr(),
            b, h, n_kv, d, l, bl, nvb, int(pack4), int(qdot_int8), int(pv_int8),
            1.0 / math.sqrt(d), dt)
    return out


def decode_attention_q(q, k_cache, k_scale, v_cache, v_scale, key_mask, *,
                       n_kv: int, head_dim: int, pack4: bool = False, layer: int = 0,
                       block: Optional[int] = None, valid_len: Optional[int] = None,
                       qdot_int8: Optional[bool] = None,
                       pv_int8: Optional[bool] = None) -> torch.Tensor:
    """K4: one decode step of attention over a quantized flat cache.

    q: [B, H*D]; k_cache/v_cache: [layers, B, L, n_kv*D] int8, or with
    pack4 [layers, B, L, n_kv*D/2] packed int4 (byte j holds flat dims j and
    j + n_kv*D/2); k_scale/v_scale: [layers, B, n_kv, L] bf16 per (token,
    kv head); key_mask: [B, L] bool with L a multiple of `block` and a valid
    key in every row's first block; valid_len: no key at or past it is
    valid (whole blocks past it are skipped). qdot_int8: int8 scores product
    on per-head-quantized q; pv_int8: int8 value product. block, qdot_int8
    and pv_int8 default to DECODE_BLOCK, DECODE_QDOT8 and DECODE_PVDOT8 at
    call time. q in fp32, bf16 or fp16. Returns [B, H*D] in q's dtype."""
    qdot_int8 = _switch(qdot_int8, DECODE_QDOT8)
    pv_int8 = _switch(pv_int8, DECODE_PVDOT8)
    kw = dict(n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, block=block,
              valid_len=valid_len, qdot_int8=qdot_int8, pv_int8=pv_int8)
    if q.device.type == "cpu":
        return decode_attention_q_reference(q, k_cache, k_scale, v_cache, v_scale,
                                            key_mask, **kw)
    out = _decode_q("wg_decode_attention_q", q, k_cache, k_scale, v_cache, v_scale, key_mask,
                    **kw)
    decode_attention_q.launches += 1
    return out


def decode_attention_q_walk(q, k_cache, k_scale, v_cache, v_scale, key_mask, *,
                            n_kv: int, head_dim: int, pack4: bool = False, layer: int = 0,
                            block: Optional[int] = None, valid_len: Optional[int] = None,
                            qdot_int8: Optional[bool] = None,
                            pv_int8: Optional[bool] = None) -> torch.Tensor:
    """K4 on the walk engine (csrc/decode_walk.cuh) in every mode, CUDA
    tensors only: the route decode_attention_q's chunk engine is held
    against, bit for bit (chip_smoke.py, tools/decode_kernels.py).
    decode_attention_q never calls it, and it counts no launches: it is a
    yardstick, not a step of any path. Arguments as decode_attention_q's."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention_q_walk: the walk takes CUDA tensors")
    qdot_int8 = _switch(qdot_int8, DECODE_QDOT8)
    pv_int8 = _switch(pv_int8, DECODE_PVDOT8)
    return _decode_q("wg_decode_attention_q_walk", q, k_cache, k_scale, v_cache, v_scale,
                     key_mask, n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer,
                     block=block, valid_len=valid_len, qdot_int8=qdot_int8, pv_int8=pv_int8)


decode_attention_q.launches = 0


# K8's launch plan (csrc/decode_chunk.cuh): a block per (row, kv head),
# group of CHUNK_QUERY_ROWS query rows and slice of CHUNK_VALUE_DIMS value
# dims, each walking its row's key blocks in order; K4 takes slices of
# STEP_VALUE_DIMS while a block's query rows times that stay within
# CHUNK_THREADS * 2 value chains
CHUNK_QUERY_ROWS = 16
CHUNK_VALUE_DIMS = 32
STEP_VALUE_DIMS = 64
CHUNK_THREADS = 256
_SMEM_MAX = 232448


@functools.lru_cache(maxsize=None)
def decode_chunk_plan(b: int, tc: int, h: int, n_kv: int, d: int, bl: int,
                      qdot_int8: bool = True,
                      value_dims: int = CHUNK_VALUE_DIMS) -> Dict[str, int]:
    """K8's grid (b * n_kv, query groups, value slices), its query rows per
    block, value dims per slice and shared memory per block in bytes (as
    decode_chunk.cuh's ChunkSmem lays it out); value_dims: K4's slices."""
    nq = tc * (h // n_kv)
    qg = min(nq, CHUNK_QUERY_ROWS)
    blp = -(-bl // 8) * 8
    ks = -(-d // 32) * 32 + 16
    align = lambda x: -(-x // 16) * 16
    vf = align(blp * ks)
    qt = vf + blp * value_dims * 4 + qg * (-(-bl // 4) * 4) * 4
    st = align(qt + (CHUNK_QUERY_ROWS * ks if qdot_int8 else qg * d * 4))
    return dict(grid=(b * n_kv, -(-nq // qg), -(-d // value_dims)), query_rows=qg,
                value_dims=value_dims, smem=st + qg * 16)


# the walk's plan (csrc/decode_walk.cuh): a block per (row, kv head) and
# group of at most WALK_QUERY_ROWS query rows
WALK_QUERY_ROWS = 32


@functools.lru_cache(maxsize=None)
def decode_attention_q_plan(b: int, h: int, n_kv: int, d: int, bl: int, qdot_int8: bool = True,
                            pv_int8: bool = False, walk: bool = False) -> Dict[str, object]:
    """K4's launch plan, as csrc/decode_attention_q.cu chooses it: the chunk
    engine at Tc = 1 (decode_chunk_plan's grid (b * n_kv, query groups,
    value slices), slices of STEP_VALUE_DIMS while min(n_rep, 16) of them
    are at most 2 * CHUNK_THREADS value chains, else CHUNK_VALUE_DIMS), or
    the walk for the int8 value product (pv_int8 with qdot_int8) and for
    decode_attention_q_walk (walk): grid (b * n_kv, query groups, 1), as
    many query rows a block as fit the shared memory (decode_walk.cuh's
    decode_launch), every dim. Returns the engine, grid, query rows, value
    dims and shared memory per block in bytes."""
    if not (walk or (qdot_int8 and pv_int8)):
        qg = min(h // n_kv, CHUNK_QUERY_ROWS)
        dims = STEP_VALUE_DIMS if qg * STEP_VALUE_DIMS <= 2 * CHUNK_THREADS else CHUNK_VALUE_DIMS
        return dict(engine="chunk", **decode_chunk_plan(b, 1, h, n_kv, d, bl, qdot_int8, dims))
    nq = h // n_kv
    smem = lambda qg: 4 * (qg * (3 * d + bl + 5) + 64) + 64 * d   # int8 codes staged
    qg = min(nq, WALK_QUERY_ROWS)
    while qg > 1 and smem(qg) > _SMEM_MAX:
        qg -= 1
    return dict(engine="walk", grid=(b * n_kv, -(-nq // qg), 1), query_rows=qg, value_dims=d,
                smem=smem(qg))


def chunk_key_blocks(cache_len: int, tc: int, l: int, bl: int) -> int:
    """The key blocks of `bl` keys K8 walks for a row: those holding a slot
    below cache_len + tc, at most l / bl."""
    return min(-(-(cache_len + tc) // bl), l // bl)


def decode_attention_q_chunk_reference(q, k_cache, k_scale, v_cache, v_scale, cache_len, *,
                                       n_kv: int, head_dim: int, pack4: bool = False,
                                       layer: int = 0, block: Optional[int] = None,
                                       qdot_int8: Optional[bool] = None) -> torch.Tensor:
    """Plain version of K8: the block walk of _quant_walk for Tc tokens, slot
    p valid for token t iff p < cache_len + t + 1, over the blocks below
    ceil((max cache_len + Tc) / block); a row's blocks past its own count
    hold no valid key for it and leave its state as it was."""
    tc = q.shape[1]
    l = k_cache.shape[2]
    bl, _ = _decode_blocks(l, block, None)
    qdot_int8 = _switch(qdot_int8, DECODE_QDOT8)
    cl = cache_len.to(device=q.device, dtype=torch.long)
    nvb = chunk_key_blocks(int(cl.max()), tc, l, bl)
    end = (cl[:, None] + torch.arange(tc, device=q.device)[None] + 1)[..., None]   # [B, Tc, 1]
    pos = torch.arange(l, device=q.device)
    return _quant_walk(q, k_cache, k_scale, v_cache, v_scale, lambda keys: pos[keys] < end,
                       nvb, n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, bl=bl,
                       qdot_int8=qdot_int8)


def decode_attention_q_chunk(q, k_cache, k_scale, v_cache, v_scale, cache_len, *,
                             n_kv: int, head_dim: int, pack4: bool = False, layer: int = 0,
                             block: Optional[int] = None,
                             qdot_int8: Optional[bool] = None) -> torch.Tensor:
    """K8: Tc-token chunk attention over a quantized flat cache (the verify
    pass of speculative decode). q: [B, Tc, H*D]; the cache as for
    decode_attention_q; cache_len: [B] int pre-chunk lengths. The chunk's
    K/V must already sit at slots [cache_len, cache_len + Tc) and the cache
    must be compact per row: token t attends slots < cache_len + t + 1.
    Token t's output is decode_attention_q's at the same position over the
    same cache. block and qdot_int8 default to DECODE_BLOCK and DECODE_QDOT8
    at call time. Returns [B, Tc, H*D] in q's dtype."""
    qdot_int8 = _switch(qdot_int8, DECODE_QDOT8)
    kw = dict(n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, block=block,
              qdot_int8=qdot_int8)
    if q.device.type == "cpu":
        return decode_attention_q_chunk_reference(q, k_cache, k_scale, v_cache, v_scale,
                                                  cache_len, **kw)
    name = "decode_attention_q_chunk"
    dt = _check_cuda(name, q)
    b, tc, hd = q.shape
    d = head_dim
    h = hd // d
    l = k_cache.shape[2]
    bl, _ = _decode_blocks(l, block, None)
    if hd % d or h % n_kv or tuple(cache_len.shape) != (b,):
        raise ValueError(f"{name}: bad q {tuple(q.shape)} or cache_len "
                         f"{tuple(cache_len.shape)} for n_kv={n_kv}, D={d}")
    _check_quant_cache(name, b, n_kv, d, l, pack4, k_cache, k_scale, v_cache, v_scale)
    _check_block(name, bl, d, lambda c: decode_chunk_plan(b, tc, h, n_kv, d, c,
                                                          qdot_int8)["smem"])
    cl = cache_len.to(device=q.device, dtype=torch.int32).contiguous()
    bufs = [q, k_cache[layer], k_scale[layer], v_cache[layer], v_scale[layer], cl]
    _check_contiguous(name, q.device, *bufs)
    out = torch.empty((b, tc, hd), dtype=q.dtype, device=q.device)
    _launch("wg_decode_attention_q_chunk", q.device, *[x.data_ptr() for x in bufs],
            out.data_ptr(), b, tc, h, n_kv, d, l, bl, int(pack4), int(qdot_int8),
            1.0 / math.sqrt(d), dt)
    decode_attention_q_chunk.launches += 1
    return out


decode_attention_q_chunk.launches = 0


def decode_attention_reference(q, k_cache, v_cache, key_mask, *, n_kv: int, layer: int = 0,
                               block: Optional[int] = None) -> torch.Tensor:
    """Plain version of K11, block by block as the TPU kernel walks the
    cache, every block visited: s = (fp32(q) * (1/sqrt(D))) . k in fp32,
    invalid logits -1e30 and p = 0, alpha = exp(m_old - m_new) unrounded, p
    cast to the cache's dtype for the value product, l = l * alpha + sum p,
    out = acc / max(l, 1e-30) in q's dtype."""
    b, hd = q.shape
    l, kd = k_cache.shape[2:]
    d = kd // n_kv
    n_rep = hd // d // n_kv
    bl, nvb = _decode_blocks(l, block, None)
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(b, n_kv, n_rep, d)
    k = k_cache[layer].reshape(b, l, n_kv, d)
    v = v_cache[layer].reshape(b, l, n_kv, d)
    m = torch.full((b, n_kv, n_rep), NEG_INF, device=q.device)
    lsum = torch.zeros((b, n_kv, n_rep), device=q.device)
    acc = torch.zeros((b, n_kv, n_rep, d), device=q.device)
    for jb in range(nvb):
        keys = slice(jb * bl, (jb + 1) * bl)
        ok = key_mask[:, None, None, keys]
        s = torch.where(ok, torch.einsum("bkrd,blkd->bkrl", qf, k[:, keys].float()), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        pv = torch.einsum("bkrl,blkd->bkrd", p.to(v.dtype).float(), v[:, keys].float())
        acc = acc * alpha[..., None] + pv
        lsum = lsum * alpha + p.sum(-1)
        m = m_new
    return (acc / lsum.clamp_min(1e-30)[..., None]).reshape(b, hd).to(q.dtype)


# K11's launch plan (csrc/decode_flat.cuh): a block per (row, kv head),
# group of FLAT_QUERY_ROWS query rows and slice of FLAT_VALUE_DIMS value
# dims, its cache streamed in tiles of FLAT_KEY_TILE keys through a ring of
# FLAT_STAGES slots; the fp32 cache and decode_attention_walk take the walk
FLAT_QUERY_ROWS = 16
FLAT_VALUE_DIMS = 32
FLAT_KEY_TILE = 64
FLAT_STAGES = 4


@functools.lru_cache(maxsize=None)
def decode_attention_plan(b: int, h: int, n_kv: int, d: int, l: int, bl: int,
                          bf16: bool = True, walk: bool = False) -> Dict[str, object]:
    """K11's launch plan, as csrc/decode_attention.cu chooses it: for a bf16
    cache (and not walk) the flat engine, grid (b * n_kv, query groups,
    value slices), and the stream of tiles each block stages, in order
    ("k" or "v", first key, keys): per block of bl keys its k tiles, then
    its value tiles; else the walk (decode_walk.cuh's decode_launch: grid
    (b * n_kv, query groups, 1), as many query rows as fit, every dim).
    Returns the engine, grid, query rows, value dims, shared memory per
    block in bytes and (flat engine) the tiles."""
    n_rep = h // n_kv
    if bf16 and not walk:
        nvb = l // bl
        qg = min(n_rep, FLAT_QUERY_ROWS)
        tiles = [(kind, jb * bl + t0, min(FLAT_KEY_TILE, bl - t0))
                 for jb in range(nvb) for kind in ("k", "v")
                 for t0 in range(0, bl, FLAT_KEY_TILE)]
        ring = FLAT_STAGES * FLAT_KEY_TILE * max(d, FLAT_VALUE_DIMS) * 2
        smem = ring + qg * d * 4 + qg * (-(-bl // 4) * 4) * 4 + qg * 16
        return dict(engine="flat", grid=(b * n_kv, -(-n_rep // qg), -(-d // FLAT_VALUE_DIMS)),
                    query_rows=qg, value_dims=FLAT_VALUE_DIMS, tiles=tiles, smem=smem)
    # the walk stages the fp cache as fp32 values, 64 keys at a time
    smem = lambda qg: 4 * (qg * (3 * d + bl + 5) + 64) + 4 * 64 * d
    qg = min(n_rep, WALK_QUERY_ROWS)
    while qg > 1 and smem(qg) > _SMEM_MAX:
        qg -= 1
    return dict(engine="walk", grid=(b * n_kv, -(-n_rep // qg), 1), query_rows=qg, value_dims=d,
                smem=smem(qg))


def _decode_flat(entry: str, q, k_cache, v_cache, key_mask, *, n_kv: int, layer: int,
                 block: int) -> torch.Tensor:
    """K11's launch through the C entry `entry` (the wrapper's, or the walk's)."""
    name = "decode_attention"
    dt = _check_cuda(name, q, k_cache, v_cache)
    b, hd = q.shape
    _, cb, l, kd = k_cache.shape
    d = kd // n_kv
    bl, _ = _decode_blocks(l, block, None)
    if (kd % n_kv or hd % d or (hd // d) % n_kv or cb != b or v_cache.shape != k_cache.shape
            or tuple(key_mask.shape) != (b, l) or key_mask.dtype != torch.bool):
        raise ValueError(f"{name}: bad inputs q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"mask {tuple(key_mask.shape)} {key_mask.dtype}, n_kv={n_kv}")
    _check_block(name, bl, d, lambda c: decode_attention_plan(
        b, hd // d, n_kv, d, l, c, q.dtype == torch.bfloat16,
        entry == "wg_decode_attention_walk")["smem"])
    bufs = [q, k_cache[layer], v_cache[layer], key_mask]
    _check_contiguous(name, q.device, *bufs)
    out = torch.empty((b, hd), dtype=q.dtype, device=q.device)
    _launch(entry, q.device, *[x.data_ptr() for x in bufs], out.data_ptr(),
            b, hd // d, n_kv, d, l, bl, 1.0 / math.sqrt(d), dt)
    return out


def decode_attention(q, k_cache, v_cache, key_mask, *, n_kv: int, layer: int = 0,
                     block: Optional[int] = None) -> torch.Tensor:
    """K11: one decode step of attention over a flat fp cache (the cache of
    LLMConfig.fused_decode). q: [B, H*D]; k_cache/v_cache: [layers, B, L,
    n_kv*D] in q's dtype with L a multiple of `block`; key_mask: [B, L] bool
    with a valid key in every row's first block. Returns [B, H*D] in q's
    dtype. Query head h reads kv head h // (H / n_kv)."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, key_mask, n_kv=n_kv,
                                          layer=layer, block=block)
    out = _decode_flat("wg_decode_attention", q, k_cache, v_cache, key_mask, n_kv=n_kv,
                       layer=layer, block=block)
    decode_attention.launches += 1
    return out


def decode_attention_walk(q, k_cache, v_cache, key_mask, *, n_kv: int, layer: int = 0,
                          block: Optional[int] = None) -> torch.Tensor:
    """K11 on the walk engine (csrc/decode_walk.cuh) in both dtypes, CUDA
    tensors only: the route decode_attention's bf16 engine is held against,
    bit for bit (chip_smoke.py, tools/decode_kernels.py). decode_attention
    never calls it for a bf16 cache, and it counts no launches. Arguments
    as decode_attention's."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention_walk: the walk takes CUDA tensors")
    return _decode_flat("wg_decode_attention_walk", q, k_cache, v_cache, key_mask, n_kv=n_kv,
                        layer=layer, block=block)


decode_attention.launches = 0

KERNELS = (flash_attention, sam_window_attention_packed, sam_flash_attention,
           decode_attention_q, decode_attention_q_chunk, decode_attention,
           flash_attention_bwd, sam_window_attention_packed_bwd, sam_flash_attention_bwd,
           sam_window_attention, sam_window_attention_bwd)
