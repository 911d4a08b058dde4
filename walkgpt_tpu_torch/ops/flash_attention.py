"""The three attention kernels of the main path, each beside its plain version.

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

Design (all three, csrc/attention_tile.cuh): one block per 64-row query tile
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
}


def _kernel(fn_name: str):
    lib_name, argtypes = _SIGNATURES[fn_name]
    fn = getattr(cuda_build.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel(fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")


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

KERNELS = (flash_attention, sam_window_attention_packed, sam_flash_attention)
