"""Per-token int8 quantization and the one-launch W8A8 GEMM (PyTorch
counterpart of walkgpt_tpu/ops/int8_gemm.py).

K13a quantize_tokens (csrc/int8_gemm.cu)
    Replaces walkgpt_tpu/ops/int8_gemm.py:quantize_tokens (_quant_kernel):
    x [..., K] -> (int8 codes [..., K], fp32 scales [..., 1]) with
    core/nn.linear's "a8" decisions (core/nn.quantize_a8).
K13b w8a8_gemm (csrc/int8_gemm.cu)
    Replaces walkgpt_tpu/ops/int8_gemm.py:w8a8_gemm (_w8a8_kernel): the same
    quantization, the exact int32 product with an int8 weight, then
    (acc * sx) * w_scale, + b and the activation in fp32, cast to x's
    dtype. The bias and activation come before the cast, unlike nn.linear
    and nn.mlp, which cast first.

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
import math
from typing import Optional, Tuple

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


def w8a8_gemm(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              b: Optional[torch.Tensor] = None, *, act: Optional[str] = None) -> torch.Tensor:
    """K13b: y = act((quant8(x) @ w_q) * sx * w_scale + b) in one launch.

    x: [..., K] (bf16 / fp32); w_q: [K, N] int8; w_scale: [N] fp32; b: [N]
    or None; act: None | "gelu_exact" | "gelu_tanh". Returns [..., N] in x's
    dtype."""
    if act not in ACTS:
        raise ValueError(f"w8a8_gemm: unknown activation {act!r}")
    if x.device.type == "cpu":
        return w8a8_gemm_reference(x, w_q, w_scale, b, act=act)
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
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    cuda_build.launch("int8_gemm", "wg_w8a8_gemm", [_P] * 5 + [_I] * 5 + [_P], x.device,
                      xm.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                      None if bias is None else bias.data_ptr(), y.data_ptr(), m, k, n,
                      ACTS[act][1], dt)
    w8a8_gemm.launches += 1
    return y.reshape(*x.shape[:-1], n)


w8a8_gemm.launches = 0

KERNELS = (quantize_tokens, w8a8_gemm)
