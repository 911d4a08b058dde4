"""Packed-int4 and W8A8 weights for the decode step, with the three matrix
kernels of the quantized formats (PyTorch counterpart of
walkgpt_tpu/ops/int4.py).

Packing ("half pairs"): for W[K, N], byte [i, j] = (q[i, j] & 0xF) |
(q[i + K/2, j] << 4), i < K/2, per-output-channel scales, levels -7..7, so a
consumer dual-dots x[:, :K/2] @ lo + x[:, K/2:] @ hi. The MLP down weight is
packed TILE-LOCAL instead (pack_down4): byte [t*T/2 + i] holds rows t*T + i
and t*T + T/2 + i, T = tile_for(I), so each intermediate tile dual-dots its
own halves.

Every kernel wrapper dispatches on the device of its input: a CPU tensor runs
the plain version (`*_reference`, which the CPU tests hold against the JAX
package); a CUDA tensor launches the hand-written kernel (csrc/, built by
ops/cuda_build.py at first use) or raises. Each counts its launches in
`<function>.launches`.

K5 int4_matmul_pallas (csrc/int4_matmul.cu on K6's mlp4_stream.cuh)
    Replaces walkgpt_tpu/ops/int4.py:int4_matmul_pallas (_mm_kernel): the
    fused int4 q/k/v and the int4 lm_head of a decode step, fp32 sums, then
    (acc * scale) in x's dtype (fp32, bf16 or fp16). Its sums run in an
    order fixed by the shapes: a row's output does not depend on the other
    rows of the call.
K6 fused_mlp_int4 (csrc/fused_mlp_int4.cu + mlp4_stream.cuh)
    Replaces walkgpt_tpu/ops/int4.py:fused_mlp_int4 (_fused_mlp_kernel):
    silu(x Wg) * (x Wu) Wd in one call; the intermediate goes through bf16
    before the down product (also for fp16 rows, as in the TPU kernel),
    each tile's partial is scaled before the sum; x in fp32, bf16 or fp16.
    Every sum has an order fixed by the shapes: a row's output does not
    depend on the other rows of the call.
K7 fused_mlp_int8 (csrc/fused_mlp_int8.cu)
    Replaces walkgpt_tpu/ops/int4.py:fused_mlp_int8 (_fused_mlp8_kernel):
    the W8A8 MLP with exact int32 products (dp4a) and the intermediate
    requantized per (row, tile), in three launches.

K6 and K7 sum the tiles' partials in tile order (a last pass over a
scratch buffer), as the TPU kernel accumulates them, so the result does
not depend on the order in which the card runs the tiles. Each kernel's
launch plan is mirrored beside its wrapper (`*_plan`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.nn import div_exact, gelu_exact, int4_matmul, int8_matmul, unpack4
from . import cuda_build

DEFAULT_MLP_TILE = 256
DEFAULT_MM_TILE = 512
# the fused kernels take decode-sized row counts; larger ones (prefill) take
# the plain products, as in the JAX package
FUSED_MLP_MAX_ROWS = 256

# the dtype codes of the C entries: K5 and K6 also take fp16 rows (code 2),
# K7 float32 or bfloat16 alone
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPES_F16 = {**_DTYPES, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int32 levels -> int8 bytes (lo & 0xF) | (hi << 4), two's complement."""
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def _quant4(wf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = div_exact(wf.abs().amax(0), 7.0).clamp_min(1e-12)
    return torch.clamp(torch.round(wf / scale), -7, 7).int(), scale


def quantize_weight4(w: torch.Tensor, pad_to: int = 0) -> Dict[str, torch.Tensor]:
    """(K, N) float -> {"w_p4": int8 [K/2, N] half-pair packed, "w_scale":
    f32 [N]}. pad_to > 0 zero-pads N to a multiple: the padded columns get
    zero codes (and the floor scale 1e-12), so they give exact zeros that
    callers slice off."""
    wf = w.float()
    k, n = wf.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    if pad_to and n % pad_to:
        wf = F.pad(wf, (0, pad_to - n % pad_to))
    q, scale = _quant4(wf)
    return {"w_p4": _pack_nibbles(q[:k // 2], q[k // 2:]), "w_scale": scale}


def dequantize4(p: Dict) -> torch.Tensor:
    """The float32 [K, N] weight of a quantize_weight4 dict."""
    lo, hi = unpack4(p["w_p4"], torch.float32)
    return torch.cat([lo, hi], dim=0) * p["w_scale"]


def tile_for(i_dim: int) -> int:
    """The intermediate tile of the tile-local down packing: the largest
    power of two <= DEFAULT_MLP_TILE dividing i_dim (11008 -> 256,
    5504 -> 128)."""
    t = DEFAULT_MLP_TILE
    while t > 2 and i_dim % t:
        t //= 2
    if i_dim % t:
        raise ValueError(f"intermediate dim {i_dim} is not packable")
    return t


def pack_down4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Down projection (I, H) -> {"w_p4t": int8 [I/2, H] tile-local half
    pairs, "w_scale": f32 [H]}."""
    wf = w.float()
    i_dim = wf.shape[0]
    tile = tile_for(i_dim)
    q, scale = _quant4(wf)
    q = q.reshape(i_dim // tile, tile, -1)
    packed = _pack_nibbles(q[:, :tile // 2], q[:, tile // 2:])
    return {"w_p4t": packed.reshape(i_dim // 2, -1), "w_scale": scale}


def _down_tiles(p: Dict, dtype) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The tile-local down weight as (lo, hi) [n_tiles, tile/2, H] and tile."""
    packed = p["w_p4t"]
    i2, hd = packed.shape
    tile = tile_for(i2 * 2)
    lo, hi = unpack4(packed.reshape(i2 // (tile // 2), tile // 2, hd), dtype)
    return lo, hi, tile


def dequantize_down4(p: Dict) -> torch.Tensor:
    """The float32 (I, H) weight of a pack_down4 dict."""
    lo, hi, _ = _down_tiles(p, torch.float32)
    return torch.cat([lo, hi], dim=1).reshape(-1, lo.shape[-1]) * p["w_scale"]


def _down_matmul_xla(p: Dict, h: torch.Tensor) -> torch.Tensor:
    """h [rows, I] @ the tile-local packed down (I, H), in h's dtype."""
    lo, hi, tile = _down_tiles(p, h.dtype)
    nt = lo.shape[0]
    hb = h.reshape(-1, nt, tile)
    y = (torch.einsum("rnt,nth->rh", hb[:, :, :tile // 2], lo)
         + torch.einsum("rnt,nth->rh", hb[:, :, tile // 2:], hi))
    return y * p["w_scale"].to(h.dtype)


def mlp_is_int4(mlp_params: Dict) -> bool:
    inner = mlp_params.get("down", mlp_params.get("fc2", {}))
    return isinstance(inner, dict) and "w_p4t" in inner


def mlp_int4_xla(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Full-sequence int4 MLP through the dual dots (prefill)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    if act == "silu":
        g = int4_matmul(xf, mlp_params["gate"]["w_p4"], mlp_params["gate"]["w_scale"])
        u = int4_matmul(xf, mlp_params["up"]["w_p4"], mlp_params["up"]["w_scale"])
        y = _down_matmul_xla(mlp_params["down"], F.silu(g) * u)
    else:
        g = int4_matmul(xf, mlp_params["fc1"]["w_p4"], mlp_params["fc1"]["w_scale"])
        y = _down_matmul_xla(mlp_params["fc2"], gelu_exact(g))
    return y.to(x.dtype).reshape(shape)


def mlp_int4(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """K6 for single-token steps of at most FUSED_MLP_MAX_ROWS rows (the
    decode step), the dual dots for everything else."""
    rows = x[..., 0].numel()
    if x.ndim >= 2 and x.shape[-2] == 1 and rows <= FUSED_MLP_MAX_ROWS:
        return fused_mlp_int4(mlp_params, x, act)
    return mlp_int4_xla(mlp_params, x, act)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] -> (int8 [..., K], f32 scale [..., 1]): symmetric per-row
    quantization that MULTIPLIES by 1/scale (unlike nn.linear's "a8")."""
    xf = x.float()
    sx = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf * (torch.ones((), device=x.device) / sx)), -127, 127)
    xq = xq.to(torch.int8)
    return xq, sx


def mlp_is_w8a8(mlp_params: Dict) -> bool:
    """Every MLP projection is W8A8 without bias or LoRA leaves."""
    names = ("gate", "up", "down") if "gate" in mlp_params else ("fc1", "fc2")
    return all(isinstance(p, dict) and "w_q" in p and "a8" in p
               and "b" not in p and "lora_a" not in p
               for p in (mlp_params.get(n) for n in names))


def _mlp_parts(mlp_params: Dict, act: str):
    """(first, up or None, down, gelu) of a silu-gated or gelu MLP."""
    if act == "silu":
        return mlp_params["gate"], mlp_params["up"], mlp_params["down"], False
    return mlp_params["fc1"], None, mlp_params["fc2"], True


def _act(g: torch.Tensor, gelu: bool) -> torch.Tensor:
    return gelu_exact(g) if gelu else F.silu(g)


def _sum_tiles(parts: torch.Tensor) -> torch.Tensor:
    """[n_tiles, ...] -> the sum in tile order, as the kernels take it."""
    y = parts[0]
    for t in range(1, parts.shape[0]):
        y = y + parts[t]
    return y


def _check_rows(name: str, x: torch.Tensor, fp16: bool = False) -> int:
    """x's dtype code; fp16: the kernel also has an fp16 route."""
    table = _DTYPES_F16 if fp16 else _DTYPES
    if x.dtype not in table:
        also = ", float16" if fp16 else ""
        raise ValueError(f"{name}: the kernel takes float32{also} or bfloat16, got {x.dtype}")
    return table[x.dtype]


def _check_weights(name: str, dev: torch.device, *ts: Optional[torch.Tensor]):
    for t in ts:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name}: weights must be contiguous on {dev}")


# ---------------------------------------------------------------------------
# K5: one-launch int4 matmul (fused q/k/v, lm_head)
# ---------------------------------------------------------------------------

def _int4_scaled(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(x[:, :K/2] lo + x[:, K/2:] hi) * s, fp32 throughout."""
    k2 = p.shape[0]
    lo, hi = unpack4(p, torch.float32)
    return (x[:, :k2].float() @ lo + x[:, k2:].float() @ hi) * s


def int4_matmul_pallas_reference(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor
                                 ) -> torch.Tensor:
    """Plain version of K5. x [M, K]; p [K/2, N] packed; s [N] f32. fp32
    sums of both halves, then (acc * s) cast to x's dtype."""
    return _int4_scaled(x, p, s).to(x.dtype)


def int4_matmul_pallas(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K5 for at most FUSED_MLP_MAX_ROWS rows when the 512 -> 256 -> 128
    output-tile search ends on a multiple of 128; the dual dot otherwise."""
    shape = x.shape
    k, n = shape[-1], p.shape[1]
    xf = x.reshape(-1, k)
    tile = DEFAULT_MM_TILE
    while n % tile:
        tile //= 2
    if xf.shape[0] > FUSED_MLP_MAX_ROWS or tile % 128:
        return int4_matmul(x, p, s)
    if x.device.type == "cpu":
        y = int4_matmul_pallas_reference(xf, p, s)
    else:
        dt = _check_rows("int4_matmul_pallas", x, fp16=True)
        _check_weights("int4_matmul_pallas", x.device, p, s)
        if p.dtype != torch.int8 or s.dtype != torch.float32 or p.shape[0] * 2 != k:
            raise ValueError(f"int4_matmul_pallas: bad weight {p.dtype} {tuple(p.shape)}, "
                             f"scale {s.dtype} for K={k}")
        xf = xf.contiguous()
        y = torch.empty((xf.shape[0], n), dtype=x.dtype, device=x.device)
        cuda_build.launch("int4_matmul", "wg_int4_matmul", [_P] * 4 + [_I] * 4 + [_P],
                          x.device, xf.data_ptr(), p.data_ptr(), s.data_ptr(), y.data_ptr(),
                          xf.shape[0], k // 2, n, dt)
        int4_matmul_pallas.launches += 1
    return y.reshape(*shape[:-1], n)


int4_matmul_pallas.launches = 0

# K5's launch plan (csrc/int4_matmul.cu): a block per INT4_MM_COLS output
# columns (2 column groups of 16 x INT4_MM_ROW_LANES row lanes), rows in
# passes of 1, 2 or 4
INT4_MM_COLS = 32
INT4_MM_ROW_LANES = 64


@functools.lru_cache(maxsize=None)
def int4_matmul_plan(m: int, k: int, n: int) -> Dict[str, int]:
    """K5's launch for m rows of width k through a [k/2, n] packed weight:
    its blocks, row lanes (lane r sums the packed rows r, r + row_lanes, ...),
    rows per pass and the fp32 shared memory of a block (the staged rows,
    later reused by the lanes' partials)."""
    rows = m if m <= 2 else 4
    return dict(blocks=-(-n // INT4_MM_COLS), row_lanes=INT4_MM_ROW_LANES, rows_per_pass=rows,
                smem_floats=max(rows * k, INT4_MM_ROW_LANES * (rows * INT4_MM_COLS + 4)))


# ---------------------------------------------------------------------------
# K6: one-launch int4 MLP
# ---------------------------------------------------------------------------

def mlp4_tile_parts(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The tile partials of K6's arithmetic (also K12's MLP phase): g = (x
    lo + x hi) * gs in fp32, act, times (x Wu) * us; h rounded to bf16; per
    tile t: (h_lo Wd_lo + h_hi Wd_hi) * ds. x [M, H] -> fp32 [n_tiles, M, H]."""
    first, up, down, gelu = _mlp_parts(mlp_params, act)
    a = _act(_int4_scaled(x, first["w_p4"], first["w_scale"]), gelu)
    if up is not None:
        a = a * _int4_scaled(x, up["w_p4"], up["w_scale"])
    h = a.to(torch.bfloat16).float()
    lo, hi, tile = _down_tiles(down, torch.float32)
    hb = h.reshape(h.shape[0], lo.shape[0], tile)
    return (torch.einsum("mnt,nth->nmh", hb[:, :, :tile // 2], lo)
            + torch.einsum("mnt,nth->nmh", hb[:, :, tile // 2:], hi)) * down["w_scale"]


def fused_mlp_int4_reference(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of K6: mlp4_tile_parts, the tiles summed in order, cast
    to x's dtype."""
    shape = x.shape
    parts = mlp4_tile_parts(mlp_params, x.reshape(-1, shape[-1]), act)
    return _sum_tiles(parts).to(x.dtype).reshape(shape)


# K6's launch plan (csrc/mlp4_stream.cuh): a gate/up block per
# MLP4_GATE_UP_COLS columns of I, a down block per (tile, MLP4_DOWN_COLS
# output columns), rows in passes of 1, 2 or 4
MLP4_GATE_UP_COLS = 32
MLP4_DOWN_COLS = 512


@functools.lru_cache(maxsize=None)
def fused_mlp_int4_plan(m: int, h: int, i_dim: int) -> Dict[str, int]:
    """K6's launches for m rows of width h through an intermediate of
    i_dim: the tile, the blocks of its gate/up and down passes, the rows per
    pass and the fp32 scratch the wrapper allocates (the tiles' partials
    [n_tiles, m, h], then from h_offset the intermediate h [m, i_dim] in
    bf16)."""
    tile = tile_for(i_dim)
    n_tiles = i_dim // tile
    parts = n_tiles * m * h
    return dict(tile=tile, n_tiles=n_tiles, gate_up_blocks=-(-i_dim // MLP4_GATE_UP_COLS),
                down_blocks=-(-h // MLP4_DOWN_COLS) * n_tiles,
                rows_per_pass=m if m <= 2 else 4, h_offset=parts,
                scratch_floats=parts + -(-m * i_dim // 2))


def fused_mlp_int4(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """K6: the int4 MLP of a decode step (three launches). mlp_params:
    {"gate", "up": {w_p4, w_scale}, "down": {w_p4t, w_scale}} (silu) or
    {"fc1", "fc2"} (gelu); x [..., H]."""
    if x.device.type == "cpu":
        return fused_mlp_int4_reference(mlp_params, x, act)
    first, up, down, gelu = _mlp_parts(mlp_params, act)
    dt = _check_rows("fused_mlp_int4", x, fp16=True)
    shape = x.shape
    h = shape[-1]
    xf = x.reshape(-1, h).contiguous()
    m = xf.shape[0]
    i_dim = first["w_p4"].shape[1]
    plan = fused_mlp_int4_plan(m, h, i_dim)
    ups = (up["w_p4"], up["w_scale"]) if up is not None else (None, None)
    _check_weights("fused_mlp_int4", x.device, first["w_p4"], first["w_scale"], *ups,
                   down["w_p4t"], down["w_scale"])
    if (h % 2 or tuple(first["w_p4"].shape) != (h // 2, i_dim)
            or tuple(down["w_p4t"].shape) != (i_dim // 2, h)):
        raise ValueError(f"fused_mlp_int4: bad shapes x {tuple(shape)}, "
                         f"first {tuple(first['w_p4'].shape)}, down {tuple(down['w_p4t'].shape)}")
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32, device=x.device)
    y = torch.empty((m, h), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.launch("fused_mlp_int4", "wg_fused_mlp_int4", [_P] * 9 + [_I] * 6 + [_P],
                      x.device, xf.data_ptr(), first["w_p4"].data_ptr(),
                      first["w_scale"].data_ptr(), ptr(ups[0]), ptr(ups[1]),
                      down["w_p4t"].data_ptr(), down["w_scale"].data_ptr(),
                      scratch.data_ptr(), y.data_ptr(), m, h, i_dim, plan["tile"], int(gelu), dt)
    fused_mlp_int4.launches += 1
    return y.reshape(shape)


fused_mlp_int4.launches = 0


def fused_mlp_int4_parts(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """K6's launches on x [M, H] (CUDA tensors only), returning the tiles'
    scaled partials [n_tiles, M, H] fp32 from its scratch: what K12's MLP
    phases, which run K6's two passes, are held to bit for bit
    (chip_smoke.py, tests/test_torch_kernels_gpu.py). fused_mlp_int4 never
    calls it, and it counts no launches."""
    first, up, down, gelu = _mlp_parts(mlp_params, act)
    if x.device.type != "cuda" or x.dim() != 2:
        raise ValueError("fused_mlp_int4_parts: a CUDA tensor [M, H]")
    dt = _check_rows("fused_mlp_int4_parts", x, fp16=True)
    m, h = x.shape
    i_dim = first["w_p4"].shape[1]
    plan = fused_mlp_int4_plan(m, h, i_dim)
    ups = (up["w_p4"], up["w_scale"]) if up is not None else (None, None)
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32, device=x.device)
    y = torch.empty((m, h), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.launch("fused_mlp_int4", "wg_fused_mlp_int4", [_P] * 9 + [_I] * 6 + [_P],
                      x.device, x.contiguous().data_ptr(), first["w_p4"].data_ptr(),
                      first["w_scale"].data_ptr(), ptr(ups[0]), ptr(ups[1]),
                      down["w_p4t"].data_ptr(), down["w_scale"].data_ptr(),
                      scratch.data_ptr(), y.data_ptr(), m, h, i_dim, plan["tile"], int(gelu), dt)
    return scratch[:plan["h_offset"]].view(plan["n_tiles"], m, h)


# ---------------------------------------------------------------------------
# K7: one-launch W8A8 MLP
# ---------------------------------------------------------------------------

def fused_mlp_int8_reference(mlp_params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of K7. xq, sx = quantize_rows(x); g = (xq Wg).f32 * sx
    * gs, act, times (xq Wu).f32 * sx * us; per tile t: hq, hs =
    quantize_rows(h_t); (hq Wd_t).f32 * hs * ds; the tiles summed in order;
    cast to x's dtype."""
    first, up, down, gelu = _mlp_parts(mlp_params, act)
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    a = _act(int8_matmul(xq, first["w_q"]).float() * sx * first["w_scale"], gelu)
    if up is not None:
        a = a * (int8_matmul(xq, up["w_q"]).float() * sx * up["w_scale"])
    tile = tile_for(a.shape[-1])
    parts = []
    for t in range(a.shape[-1] // tile):
        hq, hs = quantize_rows(a[:, t * tile:(t + 1) * tile])
        part = int8_matmul(hq, down["w_q"][t * tile:(t + 1) * tile]).float()
        parts.append(part * hs * down["w_scale"])
    return _sum_tiles(torch.stack(parts)).to(x.dtype).reshape(shape)


# K7's launch plan (csrc/fused_mlp_int8.cu): a gate/up block per
# MLP8_GATE_UP_COLS columns of I (in groups of 16, each with
# MLP8_GATE_UP_QUAD_LANES lanes a matrix, lane l summing the row quads l,
# l + lanes, ...), a down block per (tile, MLP8_DOWN_COLS output columns)
# (MLP8_DOWN_QUAD_LANES lanes over the tile's row quads), rows in passes of
# 1, 2 or 4
MLP8_GATE_UP_COLS = 32
MLP8_GATE_UP_QUAD_LANES = 64
MLP8_DOWN_COLS = 256
MLP8_DOWN_QUAD_LANES = 8


@functools.lru_cache(maxsize=None)
def fused_mlp_int8_plan(m: int, h: int, i_dim: int) -> Dict[str, int]:
    """K7's launches for m rows of width h through an intermediate of
    i_dim: the tile, the blocks of its gate/up and down passes, the rows per
    pass and the fp32 scratch the wrapper allocates (act [m, i_dim], then
    from parts_offset the tiles' partials [n_tiles, m, h])."""
    tile = tile_for(i_dim)
    n_tiles = i_dim // tile
    act = m * i_dim
    return dict(tile=tile, n_tiles=n_tiles, gate_up_blocks=-(-i_dim // MLP8_GATE_UP_COLS),
                down_blocks=-(-h // MLP8_DOWN_COLS) * n_tiles, rows_per_pass=m if m <= 2 else 4,
                parts_offset=act, scratch_floats=act + n_tiles * m * h)


def fused_mlp_int8(mlp_params: Dict, x: torch.Tensor, act: str) -> Optional[torch.Tensor]:
    """K7: the W8A8 MLP of a decode step in one call (three launches, the
    activation's per-row quantization included). None for more than
    FUSED_MLP_MAX_ROWS rows: the caller then runs the per-projection W8A8
    path."""
    if x[..., 0].numel() > FUSED_MLP_MAX_ROWS:
        return None
    if x.device.type == "cpu":
        return fused_mlp_int8_reference(mlp_params, x, act)
    first, up, down, gelu = _mlp_parts(mlp_params, act)
    dt = _check_rows("fused_mlp_int8", x)
    shape = x.shape
    h = shape[-1]
    xf = x.reshape(-1, h).contiguous()
    m = xf.shape[0]
    i_dim = first["w_q"].shape[1]
    plan = fused_mlp_int8_plan(m, h, i_dim)
    ups = (up["w_q"], up["w_scale"]) if up is not None else (None, None)
    _check_weights("fused_mlp_int8", x.device, first["w_q"], first["w_scale"], *ups,
                   down["w_q"], down["w_scale"])
    if tuple(first["w_q"].shape) != (h, i_dim) or tuple(down["w_q"].shape) != (i_dim, h):
        raise ValueError(f"fused_mlp_int8: bad shapes x {tuple(shape)}, "
                         f"first {tuple(first['w_q'].shape)}, down {tuple(down['w_q'].shape)}")
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32, device=x.device)
    y = torch.empty((m, h), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.launch("fused_mlp_int8", "wg_fused_mlp_int8", [_P] * 9 + [_I] * 6 + [_P],
                      x.device, xf.data_ptr(), first["w_q"].data_ptr(),
                      first["w_scale"].data_ptr(), ptr(ups[0]), ptr(ups[1]),
                      down["w_q"].data_ptr(), down["w_scale"].data_ptr(),
                      scratch.data_ptr(), y.data_ptr(), m, h, i_dim, plan["tile"], int(gelu), dt)
    fused_mlp_int8.launches += 1
    return y.reshape(shape)


fused_mlp_int8.launches = 0

KERNELS = (int4_matmul_pallas, fused_mlp_int4, fused_mlp_int8)
