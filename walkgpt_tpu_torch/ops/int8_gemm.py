"""Per-token int8 quantization and the one-launch W8A8 GEMM (PyTorch
counterpart of walkgpt_tpu/ops/int8_gemm.py).

K13a quantize_tokens (csrc/int8_gemm.cu)
    Replaces walkgpt_tpu/ops/int8_gemm.py:quantize_tokens (_quant_kernel):
    x [..., K] -> (int8 codes [..., K], fp32 scales [..., 1]) with
    core/nn.linear's "a8" decisions (core/nn.quantize_a8). One pass over x
    (quantize_tokens_plan): a row is held in registers, 16 values a
    segment in 16-byte loads and code stores where K % 16 == 0, between its
    absmax and its codes.
K13b w8a8_gemm (csrc/int8_gemm.cu)
    Replaces walkgpt_tpu/ops/int8_gemm.py:w8a8_gemm (_w8a8_kernel): the same
    quantization, the exact int32 product with an int8 weight, then
    (acc * sx) * w_scale, + b and the activation in fp32, cast to x's
    dtype. The bias and activation come before the cast, unlike nn.linear
    and nn.mlp, which cast first. Where K % 16 == 0 (every ViT-H product)
    a call is three launches on the int8 tensor cores (w8a8_gemm_plan):
    K13a's quantizer into scratch codes, w_q transposed K-major into
    scratch, and 128 x 128 output tiles of wgmma.mma_async fed by TMA
    through a three-stage mbarrier ring; other shapes take the first
    design (mma.sync, quantizing on the fly), which w8a8_gemm_mma_sync
    runs at any shape for comparisons. Both give the same bits.

As in the JAX package, nn.linear never calls either: they are ops for
direct use at the ViT-H W8A8 block shapes. The TPU kernel's VMEM tiling
(bm, _pick_bm, _pick_bn, fits_vmem, quantize_fits, _VMEM_BUDGET) budgets a
TPU core's 16 MB of VMEM and selects nothing on the card, so it is not
ported: the CUDA kernels fix their own tiles.

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version (`*_reference`); a CUDA tensor launches the kernel (built by
ops/cuda_build.py at first use) or raises. Each counts its launches in
`<function>.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.nn import div_exact, int8_matmul, quantize_a8
from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _gelu_exact(y: torch.Tensor) -> torch.Tensor:
    return y * 0.5 * (1.0 + torch.erf(div_exact(y, math.sqrt(2.0))))


def _gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    return y * 0.5 * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * y * y * y)))


# the TPU kernel's activations, formula for formula; the kernel's codes
ACTS = {None: (lambda y: y, 0), "gelu_exact": (_gelu_exact, 1), "gelu_tanh": (_gelu_tanh, 2)}


def _check_x(name: str, x: torch.Tensor) -> int:
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.shape[-1] % 4 or x.numel() == 0 or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes K % 4 == 0 and 16-byte aligned rows, "
                         f"got {tuple(x.shape)}")
    return _DTYPES[x.dtype]


def quantize_tokens_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K13a: core/nn.quantize_a8."""
    return quantize_a8(x)


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13a: per-token int8 quantization of x [..., K] (bf16 / fp32) in one
    pass. Returns (xq int8 [..., K], sx fp32 [..., 1]) with sx * xq ~ x."""
    if x.device.type == "cpu":
        return quantize_tokens_reference(x)
    k = x.shape[-1]
    xm = x.reshape(-1, k).contiguous()
    dt = _check_x("quantize_tokens", xm)
    m = xm.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    cuda_build.launch("int8_gemm", "wg_quantize_tokens", [_P] * 3 + [_I] * 3 + [_P], x.device,
                      xm.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k, dt)
    quantize_tokens.launches += 1
    return xq.reshape(x.shape), sx.reshape(*x.shape[:-1], 1)


quantize_tokens.launches = 0

# K13a's launch plan (csrc/int8_gemm.cu quantize_rows): QUANT_THREADS-thread
# blocks; a thread holds at most 8 segments of a row (4 of 16 fp32 values:
# 64 registers either way)
QUANT_THREADS = 256


@functools.lru_cache(maxsize=None)
def quantize_tokens_plan(m: int, k: int, dtype: torch.dtype) -> Dict[str, object]:
    """K13a's launch for x [m, k] in dtype, as csrc/int8_gemm.cu takes it:
    segments of 16 values (k % 16 == 0: 16-byte loads and a 16-byte store
    of codes) or else of 4; threads_per_row (a power of two, 32 to
    QUANT_THREADS) with segment s of a row on thread s mod threads_per_row;
    held "registers" (at most segments_per_thread, a power of two, a
    thread, all loaded before the row's absmax) or, for rows longer than a
    block holds, "two passes" (the row read for its absmax, then again for
    its codes); rows_per_block and blocks."""
    elem = 4 if dtype == torch.float32 else 2
    seg = 16 if k % 16 == 0 else 4
    nseg = k // seg
    smax = 4 if seg == 16 and elem == 4 else 8
    tpr = 32
    while tpr < QUANT_THREADS and tpr * smax < nseg:
        tpr *= 2
    held = tpr * smax >= nseg
    spt = 1
    while held and spt < -(-nseg // tpr):
        spt *= 2
    rows = QUANT_THREADS // tpr
    return dict(segment=seg, segments=nseg, threads_per_row=tpr, rows_per_block=rows,
                segments_per_thread=spt if held else -(-nseg // tpr),
                held="registers" if held else "two passes", blocks=-(-m // rows))


def quantize_tokens_info(m: int, k: int, dtype: torch.dtype) -> Dict[str, object]:
    """K13a's launch for x [m, k] in dtype as csrc/int8_gemm.cu plans it,
    from its C entry (the built library; no launch, no device): the keys of
    quantize_tokens_plan, which mirrors it."""
    info = (ctypes.c_int * 5)()
    entry = cuda_build.entry("int8_gemm", "wg_quantize_tokens_info", [_I] * 3 + [_P])
    rc = entry(m, k, _DTYPES[dtype], ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"wg_quantize_tokens_info: CUDA error {rc}")
    seg, tpr, spt, held, blocks = list(info)
    return dict(segment=seg, segments=k // seg, threads_per_row=tpr,
                rows_per_block=QUANT_THREADS // tpr, segments_per_thread=spt,
                held="registers" if held else "two passes", blocks=blocks)


def w8a8_gemm_reference(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        b: Optional[torch.Tensor] = None, *, act: Optional[str] = None
                        ) -> torch.Tensor:
    """Plain version of K13b: xq, sx = quantize_a8(x); y = (int32 xq @ w_q
    as fp32 * sx) * w_scale, + b, act, all fp32; cast to x's dtype."""
    n = w_q.shape[1]
    xq, sx = quantize_a8(x.reshape(-1, x.shape[-1]))
    y = int8_matmul(xq, w_q).float() * sx * w_scale.float()
    if b is not None:
        y = y + b.float()
    return ACTS[act][0](y).to(x.dtype).reshape(*x.shape[:-1], n)


# K13b's launch plan (csrc/int8_gemm.cu): the tensor-core route takes
# TC_TILE x TC_TILE output tiles, K in TC_K_STEP-byte stages through a ring
# of TC_STAGES, blocks of TC_THREADS (two consumer warpgroups, one producer
# warp); the first design (mma.sync) FIRST_TILE tiles of FIRST_THREADS
TC_TILE = 128
TC_K_STEP = 128
TC_STAGES = 3
TC_THREADS = 288
FIRST_TILE = (64, 128)
FIRST_THREADS = 256
SMEM_MAX = 232448


def w8a8_gemm_plan(m: int, k: int, n: int) -> Dict[str, object]:
    """K13b's launch for x [m, k] and w_q [k, n], as csrc/int8_gemm.cu takes
    it: route "wgmma" where TMA can take the rows (k % 16 == 0), then grid
    (ceil(n / 128), ceil(m / 128)) of 128 x 128 tiles, ceil(k / 128) stages
    and the dynamic shared memory per block (the ring, 1 KB for its
    alignment, the barriers); else route "mma_sync" (the first design),
    grid (ceil(n / 128), ceil(m / 64)) of 64 x 128 tiles, static shared
    memory. tile: (rows, columns) of a block's output."""
    if k % 16 == 0:
        ring = TC_STAGES * 2 * TC_TILE * TC_K_STEP
        return dict(route="wgmma", grid=(-(-n // TC_TILE), -(-m // TC_TILE)),
                    tile=(TC_TILE, TC_TILE), k_steps=-(-k // TC_K_STEP), threads=TC_THREADS,
                    smem=ring + 1024 + 2 * TC_STAGES * 8)
    bm, bn = FIRST_TILE
    words = 64 // 4 + 4
    return dict(route="mma_sync", grid=(-(-n // bn), -(-m // bm)), tile=FIRST_TILE,
                k_steps=-(-k // 64), threads=FIRST_THREADS,
                smem=4 * (bm * words + bn * words + 2 * bm))


def _w8a8_launch(x, w_q, w_scale, b, act, route: Optional[str]) -> torch.Tensor:
    """K13b's launch on the plan's route (route None) or on `route`."""
    name = "w8a8_gemm"
    k, n = w_q.shape
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    dt = _check_x(name, xm)
    ws = w_scale.float().contiguous()
    bias = None if b is None else b.float().contiguous()
    if (xm.shape[1] != k or w_q.dtype != torch.int8 or n % 4 or tuple(ws.shape) != (n,)
            or (bias is not None and tuple(bias.shape) != (n,))):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         f"{w_q.dtype}, w_scale {tuple(w_scale.shape)}")
    w_q = w_q.contiguous()
    if any(t.device != x.device for t in (w_q, ws) + ((bias,) if bias is not None else ())):
        raise ValueError(f"{name}: inputs must lie on one device")
    m = xm.shape[0]
    route = route or w8a8_gemm_plan(m, k, n)["route"]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    bias_ptr = None if bias is None else bias.data_ptr()
    if route == "wgmma":
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        sx = torch.empty((m,), dtype=torch.float32, device=x.device)
        wt = torch.empty((n, k), dtype=torch.int8, device=x.device)
        cuda_build.launch("int8_gemm", "wg_w8a8_gemm_tc", [_P] * 8 + [_I] * 5 + [_P], x.device,
                          xm.data_ptr(), w_q.data_ptr(), ws.data_ptr(), bias_ptr, xq.data_ptr(),
                          sx.data_ptr(), wt.data_ptr(), y.data_ptr(), m, k, n, ACTS[act][1], dt)
    else:
        cuda_build.launch("int8_gemm", "wg_w8a8_gemm", [_P] * 5 + [_I] * 5 + [_P], x.device,
                          xm.data_ptr(), w_q.data_ptr(), ws.data_ptr(), bias_ptr, y.data_ptr(),
                          m, k, n, ACTS[act][1], dt)
    return y.reshape(*x.shape[:-1], n)


def w8a8_gemm(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              b: Optional[torch.Tensor] = None, *, act: Optional[str] = None) -> torch.Tensor:
    """K13b: y = act((quant8(x) @ w_q) * sx * w_scale + b).

    x: [..., K] (bf16 / fp32); w_q: [K, N] int8; w_scale: [N] fp32; b: [N]
    or None; act: None | "gelu_exact" | "gelu_tanh". Returns [..., N] in x's
    dtype."""
    if act not in ACTS:
        raise ValueError(f"w8a8_gemm: unknown activation {act!r}")
    if x.device.type == "cpu":
        return w8a8_gemm_reference(x, w_q, w_scale, b, act=act)
    y = _w8a8_launch(x, w_q, w_scale, b, act, None)
    w8a8_gemm.launches += 1
    return y


def w8a8_gemm_mma_sync(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                       b: Optional[torch.Tensor] = None, *, act: Optional[str] = None
                       ) -> torch.Tensor:
    """K13b on its first design (mma.sync, one launch) at any shape, CUDA
    tensors only: the route the tensor-core one is held against, bit for
    bit (chip_smoke.py, tools/decode_kernels.py). w8a8_gemm never calls it
    at a shape TMA can take, and it counts no launches. Arguments as
    w8a8_gemm's."""
    if x.device.type != "cuda" or act not in ACTS:
        raise ValueError("w8a8_gemm_mma_sync: CUDA tensors and a known activation")
    return _w8a8_launch(x, w_q, w_scale, b, act, "mma_sync")


w8a8_gemm.launches = 0

KERNELS = (quantize_tokens, w8a8_gemm)
