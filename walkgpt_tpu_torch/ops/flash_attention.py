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
    bound by bytes on an H100 (about 9 us at 3.35 TB/s).
K2 sam_window_attention_packed (csrc/sam_window_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:sam_window_attention_packed
    (_win_packed_fwd_kernel): whole-window attention with the decomposed
    rel-pos bias, read from the unsplit qkv projection, merged heads out.
    ViT-H, 2 images: qkv [50, 196, 3840], rel [50, 196, 448] bf16: about
    109 MB and 9.8 GFLOP, bound by bytes (about 33 us).
K3 sam_flash_attention (csrc/sam_flash_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:sam_flash_attention
    (_sam_fwd_kernel): global attention over the 64x64 grid with the
    decomposed rel-pos bias built per key tile. ViT-H, 2 images:
    [2, 16, 4096, 80] bf16, about 172 GFLOP, bound by operations (about
    174 us at 989 TFLOP/s bf16).

K4 decode_attention_q (csrc/decode_attention_q.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q
    (_decode_attn_q8_kernel, _decode_attn_q_kernel): one decode step of GQA
    attention over the flat quantized cache (int8 rows, or packed int4 in
    global-halves order), walked in DECODE_BLOCK-key blocks. 7B, 2 rows,
    480 of 512 slots valid, packed int4: about 4.1 MB of k and v codes and
    scales below valid_len, bound by bytes (about 1.2 us).
K8 decode_attention_q_chunk (csrc/decode_attention_q.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention_q_chunk
    (_decode_attn_qc_kernel): the speculative verify, Tc tokens at once over
    the same cache, causal inside the chunk by cache_len. 7B, 2 rows, Tc =
    9, packed int4: about 3.8 MB, bound by bytes (about 1.1 us).
K11 decode_attention (csrc/decode_attention.cu)
    Replaces walkgpt_tpu/ops/flash_attention.py:decode_attention
    (_decode_attn_kernel): one decode step over the flat bf16 cache of
    LLMConfig.fused_decode. Dense 7B, 2 rows, 480 of 512 slots valid: about
    15.7 MB, bound by bytes (about 4.7 us).

K4, K8 and K11 run one engine (csrc/decode_walk.cuh): a block per (row,
kv head) walks the cache in DECODE_BLOCK-key blocks with the TPU kernels'
rounding points, each block's values staged once in shared memory for all
the query rows of that kv head, so K8's token t is K4's output at the same
position bit for bit.

Design (K1-K3, csrc/attention_tile.cuh): one block per 64-row query tile
and (batch, head) or (window, head); key tiles of 64 stream through shared
memory; the logits tile and its bias live only in registers and shared
memory, with an fp32 online softmax, so no [N, N] tensor reaches device
memory — the part of each bound that is bytes is met by reading each input
once per query tile. The products run on the CUDA cores in fp32, so this
first version is far from the tensor-core bound of K3 (and of K1/K2 once the
bytes are met); wgmma/TMA tiles are later work.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..core.nn import unpack4
from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
    "wg_decode_attention_q_chunk": ("decode_attention_q", [_P] * 7 + [_I] * 9 + [_F, _I, _P]),
    "wg_decode_attention": ("decode_attention", [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
}


def _check_cuda(name: str, *xs: torch.Tensor) -> int:
    dev, dt = xs[0].device, xs[0].dtype
    for x in xs:
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"{name}: all inputs must share device and dtype, "
                             f"got {[(y.device, y.dtype) for y in xs]}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    if dt not in _DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, got {dt}")
    return _DTYPES[dt]


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


# ---------------------------------------------------------------------------
# K1: causal prefill attention
# ---------------------------------------------------------------------------

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True,
                              key_valid: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1. q, k, v: [B, H, N, D]; key_valid: [B, N] bool.
    q, k, v upcast to fp32, q scaled after the upcast, masked logits -1e30.
    Returns (out [B, H, N, D] in q's dtype, lse [B, H, N] fp32)."""
    b, h, n, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (1.0 / math.sqrt(d)), k.float())
    mask = torch.ones((b, 1, 1, n), dtype=torch.bool, device=q.device)
    if key_valid is not None:
        mask = key_valid.bool()[:, None, None, :]
    if causal:
        pos = torch.arange(n, device=q.device)
        mask = mask & (pos[None, :] <= pos[:, None])
    s = torch.where(mask, s, -1e30)
    o, lse = _softmax_rows(s, v, torch.float32)
    return o.to(q.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, key_valid: Optional[torch.Tensor] = None,
                    *, return_lse: bool = False):
    """K1: self-attention over [B, H, N, D] with an optional causal mask and
    key mask key_valid [B, N] (True = attend). Returns out [B, H, N, D]
    (and lse [B, H, N] fp32 when return_lse)."""
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, causal, key_valid)
        return (out, lse) if return_lse else out
    dt = _check_cuda("flash_attention", q, k, v)
    b, h, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d > 128:
        raise ValueError(f"flash_attention: q, k, v must share a [B, H, N, D<=128] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    if key_valid is None:
        kv = torch.ones((b, n), dtype=torch.uint8, device=q.device)
    else:
        if tuple(key_valid.shape) != (b, n):
            raise ValueError(f"flash_attention: key_valid must be [{b}, {n}]")
        kv = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("wg_flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, n, d, _strides(q, k, v),
            int(causal), 1.0 / math.sqrt(d), dt)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K2: packed windowed attention (SAM ViT windowed blocks)
# ---------------------------------------------------------------------------

def sam_window_attention_packed_reference(qkv: torch.Tensor, rel: torch.Tensor,
                                          num_heads: int, head_dim: int, window: int
                                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2. qkv [BW, T, 3*H*D], rel [BW, T, 2*H*ws].
    Returns (out [BW, T, H*D] in qkv's dtype, lse [BW, T, H] fp32)."""
    bw, t, _ = qkv.shape
    h, d, ws = num_heads, head_dim, window
    c = h * d
    heads = lambda x, w: x.reshape(bw, t, h, w).transpose(1, 2)   # [BW, H, T, w]
    q, k, v = heads(qkv[..., :c], d), heads(qkv[..., c:2 * c], d), heads(qkv[..., 2 * c:], d)
    rh, rw = heads(rel[..., :h * ws], ws), heads(rel[..., h * ws:], ws)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=qkv.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    key = torch.arange(t, device=qkv.device)
    s = s + (rh.float()[..., key // ws] + rw.float()[..., key % ws])
    o, lse = _softmax_rows(s, v, qkv.dtype)
    return o.transpose(1, 2).reshape(bw, t, c).to(qkv.dtype), lse.transpose(1, 2)


def sam_window_attention_packed(qkv: torch.Tensor, rel: torch.Tensor, num_heads: int,
                                head_dim: int, window: int, *, return_lse: bool = False):
    """K2: whole-window attention with decomposed rel-pos bias over the packed
    layout. qkv: [BW, T, 3*H*D] unsplit; rel: [BW, T, 2*H*ws], lanes
    [h*ws:(h+1)*ws] = rel_h of head h, [(H+h)*ws:...] = rel_w. Returns merged
    heads [BW, T, H*D] (and lse [BW, T, H] fp32 when return_lse)."""
    if qkv.device.type == "cpu":
        out, lse = sam_window_attention_packed_reference(qkv, rel, num_heads,
                                                         head_dim, window)
        return (out, lse) if return_lse else out
    dt = _check_cuda("sam_window_attention_packed", qkv, rel)
    bw, t, _ = qkv.shape
    h, d, ws = num_heads, head_dim, window
    if (t != ws * ws or qkv.shape[-1] != 3 * h * d or tuple(rel.shape) != (bw, t, 2 * h * ws)
            or d > 128):
        raise ValueError(f"sam_window_attention_packed: bad shapes qkv {tuple(qkv.shape)}, "
                         f"rel {tuple(rel.shape)} for H={h}, D={d}, ws={ws}")
    qkv, rel = qkv.contiguous(), rel.contiguous()
    out = torch.empty((bw, t, h * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((bw, t, h), dtype=torch.float32, device=qkv.device)
    _launch("wg_sam_window_attention_fwd", qkv.device,
            qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bw, t, h, d, ws, 1.0 / math.sqrt(d), dt)
    sam_window_attention_packed.launches += 1
    return (out, lse) if return_lse else out


sam_window_attention_packed.launches = 0


# ---------------------------------------------------------------------------
# K3: global attention with decomposed rel-pos bias (SAM ViT global blocks)
# ---------------------------------------------------------------------------

def sam_flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  rel_h: torch.Tensor, rel_w: torch.Tensor,
                                  grid_hw: Tuple[int, int]
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3. q/k/v [B, H, N, D], N = gh*gw; rel_h [B, H, N, gh];
    rel_w [B, H, N, gw]. Materialises the [B, H, N, N] logits (fp32).
    Returns (out [B, H, N, D] in q's dtype, lse [B, H, N] fp32)."""
    gh, gw = grid_hw
    n, d = q.shape[2], q.shape[3]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    key = torch.arange(n, device=q.device)
    s = (s + rel_w.float()[..., key % gw]) + rel_h.float()[..., key // gw]
    o, lse = _softmax_rows(s, v, q.dtype)
    return o.to(q.dtype), lse


def sam_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_h: torch.Tensor, rel_w: torch.Tensor,
                        grid_hw: Tuple[int, int], *, return_lse: bool = False):
    """K3: SAM global attention with decomposed rel-pos bias.
    q/k/v: [B, H, N, D] with N = gh*gw; rel_h: [B, H, N, gh]; rel_w:
    [B, H, N, gw] (the per-axis projections of q on the rel-pos tables).
    Returns out [B, H, N, D] (and lse [B, H, N] fp32 when return_lse)."""
    if q.device.type == "cpu":
        out, lse = sam_flash_attention_reference(q, k, v, rel_h, rel_w, grid_hw)
        return (out, lse) if return_lse else out
    dt = _check_cuda("sam_flash_attention", q, k, v, rel_h, rel_w)
    b, h, n, d = q.shape
    gh, gw = grid_hw
    if (n != gh * gw or k.shape != q.shape or v.shape != q.shape or d > 128
            or tuple(rel_h.shape) != (b, h, n, gh) or tuple(rel_w.shape) != (b, h, n, gw)):
        raise ValueError(f"sam_flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"rel_h {tuple(rel_h.shape)}, rel_w {tuple(rel_w.shape)}, "
                         f"grid {grid_hw}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    rel_h, rel_w = rel_h.contiguous(), rel_w.contiguous()
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("wg_sam_flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, n, d, gh, gw, _strides(q, k, v),
            1.0 / math.sqrt(d), dt)
    sam_flash_attention.launches += 1
    return (out, lse) if return_lse else out


sam_flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K4, K8, K11: decode attention over the flat caches
# ---------------------------------------------------------------------------

# Length-block size of the decode-attention walk. It is part of the
# numerics (alpha and p are rounded to bf16 per block), and callers round
# the cache length up to a multiple of it (runtime/generate.py).
DECODE_BLOCK = 256
NEG_INF = -1e30


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


def _decode_blocks(l: int, block: int, valid_len: Optional[int]) -> Tuple[int, int]:
    bl = min(block, l)
    if l % bl:
        raise ValueError(f"decode attention: cache length {l} is not a multiple of {bl}")
    nvb = l // bl if valid_len is None else min(-(-int(valid_len) // bl), l // bl)
    return bl, nvb


def _quant_walk(q, k_cache, k_scale, v_cache, v_scale, valid, nvb: int, *, n_kv: int,
                head_dim: int, pack4: bool, layer: int, bl: int, qdot_int8: bool,
                pv_int8: bool = False) -> torch.Tensor:
    """The block walk of K4 and K8 (plain), in order over the first nvb
    blocks of `bl` keys: per block, scores (int q8.k times ks * (qs * scale),
    or bf16 q.k times ks * scale), logits of invalid keys -1e30, the running
    max, alpha = exp(m_old - m_new), l updated with the unrounded alpha, p*vs
    rounded to bf16 for the value product (or, with pv_int8, quantized per
    query row per block), acc scaled by bf16(alpha); at the end acc /
    bf16(l). q [B, T, H*D]; valid(keys) -> bool [B, T, len(keys)]. A block
    with no valid key for a query row leaves its state exactly as it was.
    Returns [B, T, H*D] in q's dtype."""
    b, tq, hd = q.shape
    d = head_dim
    n_rep = hd // d // n_kv
    scale = 1.0 / math.sqrt(d)
    k = _cache_rows(k_cache[layer], n_kv, d, pack4)              # [B, L, n_kv, D]
    v = _cache_rows(v_cache[layer], n_kv, d, pack4)
    ks = k_scale[layer].float()[:, None, :, None]                 # [B, 1, n_kv, 1, L]
    vs = v_scale[layer].float()[:, None, :, None]
    if qdot_int8:
        q8, qs = banded_q8_chunk(q, n_kv=n_kv, head_dim=d)
        qk, q_scale = q8.float(), (qs * scale)[..., None]         # [B, T, n_kv, n_rep, 1]
    else:
        qk, q_scale = banded_q_chunk(q, n_kv=n_kv, head_dim=d).float(), scale
    m = torch.full((b, tq, n_kv, n_rep), NEG_INF, device=q.device)
    lsum = torch.zeros((b, tq, n_kv, n_rep), device=q.device)
    acc = torch.zeros((b, tq, n_kv, n_rep, d), device=q.device)
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
        if pv_int8 and qdot_int8:
            psc = pv.amax(-1).clamp_min(1e-20) * (1.0 / 127.0)
            y = torch.einsum("btkrl,blkd->btkrd", torch.round(pv / psc[..., None]),
                             v[:, keys]) * psc[..., None]
        else:
            y = torch.einsum("btkrl,blkd->btkrd", pv.to(torch.bfloat16).float(), v[:, keys])
        acc = acc * alpha.to(torch.bfloat16).float()[..., None] + y
    out = acc / lsum.to(torch.bfloat16).float().clamp_min(1e-30)[..., None]
    return out.reshape(b, tq, hd).to(q.dtype)


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
                                 layer: int = 0, block: int = DECODE_BLOCK,
                                 valid_len: Optional[int] = None, qdot_int8: bool = True,
                                 pv_int8: bool = False) -> torch.Tensor:
    """Plain version of K4: the block walk of _quant_walk for one token over
    the key mask; blocks at or past ceil(valid_len / block) are skipped.
    pv_int8 applies with qdot_int8 only, as in the TPU kernels."""
    bl, nvb = _decode_blocks(k_cache.shape[2], block, valid_len)
    return _quant_walk(q[:, None], k_cache, k_scale, v_cache, v_scale,
                       lambda keys: key_mask[:, None, keys], nvb, n_kv=n_kv,
                       head_dim=head_dim, pack4=pack4, layer=layer, bl=bl,
                       qdot_int8=qdot_int8, pv_int8=pv_int8)[:, 0]


def decode_attention_q(q, k_cache, k_scale, v_cache, v_scale, key_mask, *,
                       n_kv: int, head_dim: int, pack4: bool = False, layer: int = 0,
                       block: int = DECODE_BLOCK, valid_len: Optional[int] = None,
                       qdot_int8: bool = True, pv_int8: bool = False) -> torch.Tensor:
    """K4: one decode step of attention over a quantized flat cache.

    q: [B, H*D]; k_cache/v_cache: [layers, B, L, n_kv*D] int8, or with
    pack4 [layers, B, L, n_kv*D/2] packed int4 (byte j holds flat dims j and
    j + n_kv*D/2); k_scale/v_scale: [layers, B, n_kv, L] bf16 per (token,
    kv head); key_mask: [B, L] bool with L a multiple of `block` and a valid
    key in every row's first block; valid_len: no key at or past it is
    valid (whole blocks past it are skipped). qdot_int8: int8 scores product
    on per-head-quantized q; pv_int8: int8 value product. Returns [B, H*D]
    in q's dtype."""
    kw = dict(n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, block=block,
              valid_len=valid_len, qdot_int8=qdot_int8, pv_int8=pv_int8)
    if q.device.type == "cpu":
        return decode_attention_q_reference(q, k_cache, k_scale, v_cache, v_scale,
                                            key_mask, **kw)
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
    bufs = [q, k_cache[layer], k_scale[layer], v_cache[layer], v_scale[layer], key_mask]
    _check_contiguous(name, q.device, *bufs)
    out = torch.empty((b, hd), dtype=q.dtype, device=q.device)
    _launch("wg_decode_attention_q", q.device, *[x.data_ptr() for x in bufs], out.data_ptr(),
            b, h, n_kv, d, l, bl, nvb, int(pack4), int(qdot_int8), int(pv_int8),
            1.0 / math.sqrt(d), dt)
    decode_attention_q.launches += 1
    return out


decode_attention_q.launches = 0


def decode_attention_q_chunk_reference(q, k_cache, k_scale, v_cache, v_scale, cache_len, *,
                                       n_kv: int, head_dim: int, pack4: bool = False,
                                       layer: int = 0, block: int = DECODE_BLOCK,
                                       qdot_int8: bool = True) -> torch.Tensor:
    """Plain version of K8: the block walk of _quant_walk for Tc tokens, slot
    p valid for token t iff p < cache_len + t + 1, over the blocks below
    ceil((max cache_len + Tc) / block); a row's blocks past its own count
    hold no valid key for it and leave its state as it was."""
    tc = q.shape[1]
    l = k_cache.shape[2]
    bl, _ = _decode_blocks(l, block, None)
    cl = cache_len.to(device=q.device, dtype=torch.long)
    nvb = min(-(-(int(cl.max()) + tc) // bl), l // bl)
    end = (cl[:, None] + torch.arange(tc, device=q.device)[None] + 1)[..., None]   # [B, Tc, 1]
    pos = torch.arange(l, device=q.device)
    return _quant_walk(q, k_cache, k_scale, v_cache, v_scale, lambda keys: pos[keys] < end,
                       nvb, n_kv=n_kv, head_dim=head_dim, pack4=pack4, layer=layer, bl=bl,
                       qdot_int8=qdot_int8)


def decode_attention_q_chunk(q, k_cache, k_scale, v_cache, v_scale, cache_len, *,
                             n_kv: int, head_dim: int, pack4: bool = False, layer: int = 0,
                             block: int = DECODE_BLOCK, qdot_int8: bool = True) -> torch.Tensor:
    """K8: Tc-token chunk attention over a quantized flat cache (the verify
    pass of speculative decode). q: [B, Tc, H*D]; the cache as for
    decode_attention_q; cache_len: [B] int pre-chunk lengths. The chunk's
    K/V must already sit at slots [cache_len, cache_len + Tc) and the cache
    must be compact per row: token t attends slots < cache_len + t + 1.
    Token t's output is decode_attention_q's at the same position over the
    same cache. Returns [B, Tc, H*D] in q's dtype."""
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
                               block: int = DECODE_BLOCK) -> torch.Tensor:
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


def decode_attention(q, k_cache, v_cache, key_mask, *, n_kv: int, layer: int = 0,
                     block: int = DECODE_BLOCK) -> torch.Tensor:
    """K11: one decode step of attention over a flat fp cache (the cache of
    LLMConfig.fused_decode). q: [B, H*D]; k_cache/v_cache: [layers, B, L,
    n_kv*D] in q's dtype with L a multiple of `block`; key_mask: [B, L] bool
    with a valid key in every row's first block. Returns [B, H*D] in q's
    dtype. Query head h reads kv head h // (H / n_kv)."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, key_mask, n_kv=n_kv,
                                          layer=layer, block=block)
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
    bufs = [q, k_cache[layer], v_cache[layer], key_mask]
    _check_contiguous(name, q.device, *bufs)
    out = torch.empty((b, hd), dtype=q.dtype, device=q.device)
    _launch("wg_decode_attention", q.device, *[x.data_ptr() for x in bufs], out.data_ptr(),
            b, hd // d, n_kv, d, l, bl, 1.0 / math.sqrt(d), dt)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

KERNELS = (flash_attention, sam_window_attention_packed, sam_flash_attention,
           decode_attention_q, decode_attention_q_chunk, decode_attention)
