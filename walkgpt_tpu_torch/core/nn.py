"""Functional neural-net primitives over parameter trees (PyTorch).

Counterpart of `walkgpt_tpu/core/nn.py`: every module is an (init, apply)
pair of plain functions over nested dicts of tensors, with the JAX package's
layouts — linear weights [in, out] (`y = x @ w`), convolution
activations NHWC and kernels HWIO, permuted to PyTorch's NCHW/OIHW at the
call, never in the stored tree.

Mixed dtypes promote as JAX promotes them (a bf16 activation meeting an fp32
weight computes in fp32), so the same tree runs the same arithmetic in both
packages.

Inits draw from a `torch.Generator`; every leaf is created directly on the
generator's device in its final dtype, so a 7B tree never exists on the host.
Numbers differ from the JAX inits (different generators); the parity tests
carry the JAX parameters across with `core.tree.from_numpy_tree`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _empty(g: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=g.device)


def uniform(g, shape, bound: float, dtype=torch.float32) -> torch.Tensor:
    return _empty(g, shape, dtype).uniform_(-bound, bound, generator=g)


def trunc_normal(g, shape, std=0.02, dtype=torch.float32) -> torch.Tensor:
    """Truncated normal in (-2*std, 2*std)."""
    t = _empty(g, shape, torch.float32)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=g)
    return t.to(dtype)


def normal(g, shape, std: float, dtype=torch.float32) -> torch.Tensor:
    return _empty(g, shape, dtype).normal_(0.0, std, generator=g)


def kaiming_uniform(g, shape, fan_in, dtype=torch.float32) -> torch.Tensor:
    """torch's default Linear/Conv kernel init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return uniform(g, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype)


def orthogonal(g, shape, gain=1.0, dtype=torch.float32) -> torch.Tensor:
    """Orthogonal init for 2D (d_in, d_out) weights."""
    n_rows, n_cols = shape
    big, small = max(n_rows, n_cols), min(n_rows, n_cols)
    a = normal(g, (big, small), 1.0)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return (gain * q).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------

def linear_init(g, d_in: int, d_out: int, *, bias: bool = True,
                init: str = "torch", std: float = 0.02,
                dtype=torch.float32) -> Params:
    if init == "torch":
        w = kaiming_uniform(g, (d_in, d_out), d_in, dtype)
    elif init == "trunc_normal":
        w = trunc_normal(g, (d_in, d_out), std, dtype)
    elif init == "orthogonal":
        w = orthogonal(g, (d_in, d_out), gain=std, dtype=dtype)
    elif init == "zeros":
        w = _empty(g, (d_in, d_out), dtype).zero_()
    else:
        raise ValueError(init)
    p: Params = {"w": w}
    if bias:
        if init == "torch":
            p["b"] = uniform(g, (d_out,), 1.0 / math.sqrt(max(1, d_in)), dtype)
        else:
            p["b"] = _empty(g, (d_out,), dtype).zero_()
    return p


def _promote(*xs: torch.Tensor):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, on every device. On CUDA, PyTorch divides by a
    Python number as a multiplication by its reciprocal (two roundings), so
    a quantizer's scales would differ in the last bit between the card and
    the CPU (and the JAX package); a 0-d tensor divisor takes the true
    division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 matrices a [M, K] and b [K, N].

    The JAX package leaves this product to XLA; here it is a library call
    too: `a.int() @ b.int()` on the CPU, and on CUDA `torch._int_mm`
    (cuBLASLt), which takes no fewer than 17 rows and K, N in multiples of
    8, and at a short K (K7's 32-wide tiles) refuses a row count that is
    not a multiple of 8 — short or ragged operands are zero-padded (exact)
    and the result sliced. A float product of int8 values is not exact at
    K = 4096 (127^2 * 4096 > 2^24)."""
    if a.device.type != "cuda":
        return a.int() @ b.int()
    m, k = a.shape
    n = b.shape[1]
    pad_m = 32 - m if m <= 16 else -m % 8
    pad_k, pad_n = -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    y = torch._int_mm(a.contiguous(), b.contiguous())
    return y[:m, :n] if (pad_m or pad_n) else y


def unpack4(p: torch.Tensor, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed int4 bytes -> (lo, hi) in `dtype`: the sign-extended low
    nibble and the arithmetic-shifted high nibble of each byte."""
    p32 = p.int()
    return ((p32 << 28) >> 28).to(dtype), (p32 >> 4).to(dtype)


def int4_matmul(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The dual dot of a half-pair packed int4 weight p [K/2, N] in x's
    dtype: x[..., :K/2] @ lo + x[..., K/2:] @ hi, times the scale s [N]
    (each half rounds to x's dtype)."""
    k2 = p.shape[0]
    lo, hi = unpack4(p, x.dtype)
    return (x[..., :k2] @ lo + x[..., k2:] @ hi) * s.to(x.dtype)


def quantize_a8(x: torch.Tensor, amax_reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token int8 quantizer of the "a8" format (W8A8) on x [..., K]:
    inv = 127 / max(|x|max, 1e-8) in fp32, rounded to x's dtype; codes
    clip(round(x * inv), -127, 127) with the product in x's dtype (a bf16 x
    * inv rounds to bf16 before the round to int) and half to even; sx =
    1 / inv in fp32. amax_reduce(ax), when given, replaces the per-token
    |x|max [..., 1] (in x's dtype) before the rest (linear's hook). Returns
    (int8 [..., K], fp32 [..., 1])."""
    # a Python number over a tensor is computed as a reciprocal times the
    # number; dividing a 0-d tensor rounds once, as the JAX package does
    one = torch.ones((), device=x.device)
    ax = x.abs().amax(-1, keepdim=True)
    if amax_reduce is not None:
        ax = amax_reduce(ax)
    inv = (127.0 * one / ax.float().clamp_min(1e-8))
    inv = inv.to(x.dtype)
    xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return xq, one / inv.float()


def linear(p: Params, x: torch.Tensor, amax_reduce=None, reduce=None) -> torch.Tensor:
    """`x @ w (+ b)` and the JAX package's quantized formats
    (`walkgpt_tpu/core/nn.py:95-143`, `ops/quant.py`, `ops/int4.py`):

    - "a8" (W8A8): per-token int8 activations, an exact int32 product with
      the int8 weight, then the two scales. The activation is quantized in
      x's dtype (a bf16 x * inv rounds to bf16 before the round to int).
      amax_reduce: fn(ax) -> ax on the per-token absmax before the
      quantize; tensor parallelism (parallel/tp.py, parallel/gspmd.py)
      passes the pmax over the tp ranks for the row-parallel projections,
      whose input is head- or intermediate-sharded, so every rank's codes
      are the single device's (a local amax re-bins each shard: 5e-2
      hidden-state drift at tiny scale in the JAX package). The other
      formats ignore it;
    - "w_q" (weight-only int8): x @ w_q in x's dtype, times the scale;
    - "w_p4" (packed int4, half pairs): the dual dot
      x[:, :K/2] @ lo + x[:, K/2:] @ hi in x's dtype, times the scale.

    reduce: fn(y) -> y on the product before its scales and the bias (the
    GSPMD leg's sum of a row-parallel projection's partial products over
    tp, where XLA places it: a W8A8 product's int32 partials sum exactly).
    Not for "w_p4"."""
    red = reduce or (lambda y: y)
    if "a8" in p:
        xq, sx = quantize_a8(x, amax_reduce)
        y = red(int8_matmul(xq.reshape(-1, xq.shape[-1]), p["w_q"]))
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        y = (y.float() * sx * p["w_scale"]).to(x.dtype)
    elif "w_q" in p:
        y = red(x @ p["w_q"].to(x.dtype)) * p["w_scale"].to(x.dtype)
    elif "w_p4" in p:
        if reduce is not None:
            raise ValueError("linear: a packed int4 product takes no reduce")
        y = int4_matmul(x, p["w_p4"], p["w_scale"])
    else:
        x, w = _promote(x, p["w"])
        y = red(x @ w)
        if "b" in p:
            y = y + p["b"]
        return y
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding_init(g, vocab: int, dim: int, *, std: float = 0.02,
                   dtype=torch.float32) -> Params:
    return {"w": normal(g, (vocab, dim), std, dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["w"])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def layer_norm_init(g, dim: int, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=g.device),
            "bias": torch.zeros((dim,), dtype=dtype, device=g.device)}


def layer_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; statistics in fp32 for bf16 safety."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layer_norm2d(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """SAM's channel LayerNorm on NHWC maps (normalizes the channel axis)."""
    return layer_norm(p, x, eps=eps)


def rms_norm_init(g, dim: int, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=g.device)}


def rms_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# convolutions (NHWC activations / HWIO kernels)
# ---------------------------------------------------------------------------

def conv2d_init(g, in_ch: int, out_ch: int, kernel: Tuple[int, int], *,
                bias: bool = True, dtype=torch.float32) -> Params:
    kh, kw = kernel
    fan_in = in_ch * kh * kw
    p: Params = {"w": kaiming_uniform(g, (kh, kw, in_ch, out_ch), fan_in, dtype)}
    if bias:
        p["b"] = uniform(g, (out_ch,), 1.0 / math.sqrt(fan_in), dtype)
    return p


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding: output ceil(size/s), the extra pixel low-side last."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, *, stride: Tuple[int, int] = (1, 1),
           padding: str = "SAME") -> torch.Tensor:
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)            # HWIO -> OIHW
    xc = x.permute(0, 3, 1, 2)                             # NHWC -> NCHW
    if padding == "SAME":
        kh, kw = w.shape[2], w.shape[3]
        ph = _same_pads(xc.shape[2], kh, stride[0])
        pw = _same_pads(xc.shape[3], kw, stride[1])
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(padding)
    y = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def conv_transpose2d_init(g, in_ch: int, out_ch: int, kernel: Tuple[int, int], *,
                          bias: bool = True, dtype=torch.float32) -> Params:
    return conv2d_init(g, in_ch, out_ch, kernel, bias=bias, dtype=dtype)


def conv_transpose2d(p: Params, x: torch.Tensor, *, stride: Tuple[int, int]) -> torch.Tensor:
    """Transposed conv with torch ConvTranspose2d semantics, VALID padding.

    The JAX package stores the kernel so that torch's (in, out, kh, kw)
    weight is a pure axis transpose of HWIO (it flips inside its call)."""
    w = p["w"].to(x.dtype).permute(2, 3, 0, 1)            # HWIO -> (in, out, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# mlp blocks
# ---------------------------------------------------------------------------

def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (jax.nn.gelu's default)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(g, d_model: int, d_hidden: int, *, d_out: Optional[int] = None,
             dtype=torch.float32) -> Params:
    return {"fc1": linear_init(g, d_model, d_hidden, dtype=dtype),
            "fc2": linear_init(g, d_hidden, d_out or d_model, dtype=dtype)}


def mlp(p: Params, x: torch.Tensor, *,
        act: Callable[[torch.Tensor], torch.Tensor] = gelu_tanh) -> torch.Tensor:
    return linear(p["fc2"], act(linear(p["fc1"], x)))


def relu_mlp_stack_init(g, dims: Sequence[int], dtype=torch.float32) -> Params:
    """A torch-style MLP([d0, d1, ..., dn]) with ReLU between layers."""
    return {"layers": [linear_init(g, dims[i], dims[i + 1], dtype=dtype)
                       for i in range(len(dims) - 1)]}


def relu_mlp_stack(p: Params, x: torch.Tensor, *,
                   sigmoid_output: bool = False) -> torch.Tensor:
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = linear(lp, x)
        if i < n - 1:
            x = F.relu(x)
    if sigmoid_output:
        x = torch.sigmoid(x)
    return x


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def count_params(tree) -> int:
    """Logical parameter count of a tree: nibble-packed int4 buffers
    ("w_p4", "w_p4t") hold two weights per byte and count double, so a 7B
    model reports 7B whether dense, int8 or int4-packed. Bool markers and
    None leaves count nothing."""
    def walk(node, key):
        if isinstance(node, dict):
            return sum(walk(v, k) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return sum(walk(v, key) for v in node)
        if isinstance(node, torch.Tensor):
            return node.numel() * (2 if key in ("w_p4", "w_p4t") else 1)
        return 0
    return walk(tree, None)


def cast_tree(tree, dtype: torch.dtype):
    """The tree with every floating tensor leaf cast to dtype (integer codes,
    bools and None as they are)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
