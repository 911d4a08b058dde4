#!/usr/bin/env python3
"""Drive the PyTorch port of WalkGPT on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--max-new-tokens 64]

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit; build the CUDA kernels
     (one nvcc per source, in parallel) and print the build time.
  2. kernels: K1 (flash_attention), K2 (sam_window_attention_packed) and K3
     (sam_flash_attention) against their plain versions at the shapes the
     WalkGPT-7B main path gives them; K4 (decode_attention_q), K5
     (int4_matmul_pallas), K6 (fused_mlp_int4) and K7 (fused_mlp_int8) at
     the shapes of the quantized 7B and 1B paths (2b); K8
     (decode_attention_q_chunk) at the speculative chunk of both, K8's
     tokens against K4 at the same positions bit for bit, and K11
     (decode_attention) at the dense 7B fused_decode step (2c); all in
     bf16, and again in fp32 at small ragged shapes; kernel, plain-version
     and library times, and the bound. The W8A8 int32 product on the card
     against the CPU's, bit for bit.
  3. parity: demo_config in fp32 (TF32 off) through generate_and_segment
     with the kernels and with the einsum attention, same random weights:
     identical tokens, masks within 1e-3. Then demo_config in both quantized
     formats, the same request on the CPU (plain versions) and on the card
     (kernels): identical tokens, lengths and [SEG] rows, every new kernel
     launched; masks within 1e-3 with float SAM blocks, and within 2% of
     their largest magnitude with the deployed W8A8 SAM blocks
     (QUANT_MASK_REL says why). 3c: speculative decode (speculative_k=8)
     at demo_config over the int4_flat cache (7B format, float SAM blocks),
     the int8_flat cache and the heads fp32 and int8 caches (dense), the
     card against the CPU: identical tokens, lengths and [SEG] rows, masks
     within 1e-3 (the 1B format's W8A8 run is reported beside them);
     greedy with fused_decode (K11) against the heads layout on the card.
  4. the slices at full width, random weights from --seed built on the card,
     two requests of 2 images and 2 prompt rows each, with launch counts per
     request, peak memory, and the warm request's phase times on the host
     clock and on the card (torch.profiler):
       a. walkgpt_7b_config (SAM ViT-H at 1024^2, LLaMA-7B), bf16 weights;
       b. WalkGPT-7B in its production format: int4 MLPs, fused q/k/v and
          lm_head, W8A8 o-proj and SAM blocks, the packed int4 flat cache;
       c. WalkGPT-1B (flagship_1b_config) in its production format: W8A8
          weights with the fused qkv8, W8A8 SAM blocks, the int8 flat cache.
     b and c then run two requests with speculative_k=8 (K8 in every
     verify iteration and layer, counts checked exactly) and time the
     speculative schedule at force_accept 0 and 8; a then runs two
     requests with fused_decode (K11 in every step and layer).
Then one JSON line with every kernel's numbers and, last, the device line.
Needs one CUDA GPU and nvcc (CUDA_HOME or /usr/local/cuda); exits non-zero
without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from walkgpt_tpu_torch.core.config import demo_config, flagship_1b_config, walkgpt_7b_config
from walkgpt_tpu_torch.core.nn import int8_matmul, unpack4
from walkgpt_tpu_torch.models import llm, walkgpt
from walkgpt_tpu_torch.ops import cuda_build, int4, quant
from walkgpt_tpu_torch.ops import flash_attention as fa
from walkgpt_tpu_torch.runtime import generate

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, int8 tensor
# cores, fp32 outside the tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
KERNELS = fa.KERNELS + int4.KERNELS
SPEC_K = 8                  # drafts per verify iteration (the JAX sweep's draft_k)

# the production formats (the JAX package's bench.py): WalkGPT-7B "int4x"
# with the packed int4 flat cache, WalkGPT-1B W8A8 with the int8 flat cache
FORMAT_7B = dict(act_quant=True, sam_int8=True, mlp_int4=True, attn_int4=True,
                 head_int4=True)
FORMAT_1B = dict(act_quant=True, sam_int8=True)

# bf16 comparison of a kernel with its plain version on the same bf16 inputs:
# both round q*scale and p at the same points and accumulate in fp32 in
# another order, so outputs differ by about one bf16 rounding step of values
# of order one (2^-8 relative), more where an fp32 sum straddles a rounding
# boundary of p.
BF16_MAX_ABS, BF16_MEAN_ABS = 3e-2, 3e-3
FP32_ATOL = 1e-4
# K4-K7 round inside (K4's p and alpha and K6's intermediate to bf16, K7's
# intermediate to int8 codes), so a last-place difference before such a
# point moves one term by a bf16 step or one code: their errors are taken
# relative to the output's largest magnitude (at least 1).
QUANT_FP32_REL = 1e-3
# W8A8 SAM blocks quantize every activation of the image encoder to int8
# codes. The card and the CPU take their fp32 sums in another order, so a
# value on the edge between two codes can land on either side, and one code
# that moves moves the image features by ~1e-2 and the masks by up to ~1% of
# their largest magnitude, while tokens and [SEG] rows stay the same. Only
# the runs with W8A8 SAM blocks take this limit; with float SAM blocks (the
# LLM still quantized) phase 3b holds the masks to 1e-3.
QUANT_MASK_REL = 2e-2

KERNEL_INFO = {
    "flash_attention": ("walkgpt_tpu_torch/csrc/flash_attention.cu",
                        "walkgpt_tpu/ops/flash_attention.py:51"),
    "sam_window_attention_packed": ("walkgpt_tpu_torch/csrc/sam_window_attention.cu",
                                    "walkgpt_tpu/ops/flash_attention.py:958"),
    "sam_flash_attention": ("walkgpt_tpu_torch/csrc/sam_flash_attention.cu",
                            "walkgpt_tpu/ops/flash_attention.py:372"),
    "decode_attention_q": ("walkgpt_tpu_torch/csrc/decode_attention_q.cu",
                           "walkgpt_tpu/ops/flash_attention.py:1327"),
    "int4_matmul_pallas": ("walkgpt_tpu_torch/csrc/int4_matmul.cu",
                           "walkgpt_tpu/ops/int4.py:463"),
    "fused_mlp_int4": ("walkgpt_tpu_torch/csrc/fused_mlp_int4.cu",
                       "walkgpt_tpu/ops/int4.py:105"),
    "fused_mlp_int8": ("walkgpt_tpu_torch/csrc/fused_mlp_int8.cu",
                       "walkgpt_tpu/ops/int4.py:351"),
    "decode_attention_q_chunk": ("walkgpt_tpu_torch/csrc/decode_attention_q.cu",
                                 "walkgpt_tpu/ops/flash_attention.py:1519"),
    "decode_attention": ("walkgpt_tpu_torch/csrc/decode_attention.cu",
                         "walkgpt_tpu/ops/flash_attention.py:1154"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def errors(got, want):
    err = (got.float() - want.float()).abs()
    return float(err.max()), float(err.mean())


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def k1_case(dev, dtype, b, h, n, d, lengths, gen):
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype) for _ in range(3))
    kv = torch.arange(n, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
    run = lambda: fa.flash_attention(q, k, v, True, kv, return_lse=True)
    plain = lambda: fa.flash_attention_reference(q, k, v, True, kv)
    pos = torch.arange(n, device=dev)
    mask = (pos[None, :] <= pos[:, None])[None, None] & kv[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    pairs = n * (n + 1) // 2                     # causal (q, k <= q) pairs per head
    out_bytes = b * h * n * d * q.element_size() + b * h * n * 4
    cost = (nbytes(q, k, v, kv) + out_bytes, 4.0 * d * pairs * b * h, dtype)
    return run, plain, library, cost


def k2_case(dev, dtype, bw, h, d, ws, gen):
    t = ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=gen, device=dev).to(dtype)
    rel = torch.randn(bw, t, 2 * h * ws, generator=gen, device=dev).to(dtype)
    run = lambda: fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    plain = lambda: fa.sam_window_attention_packed_reference(qkv, rel, h, d, ws)
    c = h * d
    heads = lambda x, w: x.reshape(bw, t, h, w).transpose(1, 2)
    q, k, v = heads(qkv[..., :c], d), heads(qkv[..., c:2 * c], d), heads(qkv[..., 2 * c:], d)
    key = torch.arange(t, device=dev)
    bias = (heads(rel[..., :h * ws], ws)[..., key // ws]
            + heads(rel[..., h * ws:], ws)[..., key % ws]).to(dtype)
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    out_bytes = bw * t * c * qkv.element_size() + bw * t * h * 4
    cost = (nbytes(qkv, rel) + out_bytes, 4.0 * d * t * t * bw * h, dtype)
    return run, plain, library, cost


def k3_case(dev, dtype, b, h, gh, gw, d, gen):
    n = gh * gw
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype) for _ in range(3))
    rel_h = torch.randn(b, h, n, gh, generator=gen, device=dev).to(dtype)
    rel_w = torch.randn(b, h, n, gw, generator=gen, device=dev).to(dtype)
    run = lambda: fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    plain = lambda: fa.sam_flash_attention_reference(q, k, v, rel_h, rel_w, (gh, gw))
    key = torch.arange(n, device=dev)
    bias = rel_h[..., key // gw] + rel_w[..., key % gw]      # [B, H, N, N], built once
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    out_bytes = b * h * n * d * q.element_size() + b * h * n * 4
    cost = (nbytes(q, k, v, rel_h, rel_w) + out_bytes, 4.0 * d * n * n * b * h, dtype)
    return run, plain, library, cost


def check_kernel(name, case, dtype, iters, plain_iters, label="", relative=False):
    """A kernel's wrapper against its plain version on the same inputs (and
    its lse where it returns one), then (iters > 0) kernel, plain and
    library times and the bound. relative: errors are taken relative to the
    output's largest magnitude (at least 1), fp32 ones within
    QUANT_FP32_REL."""
    run, plain, library, (nb, ops, ops_type) = case
    out = run()
    torch.cuda.synchronize()
    ref, plain_ms = host_ms(plain)
    (out, lse), (ref, ref_lse) = ((t if isinstance(t, tuple) else (t, None)) for t in (out, ref))
    scale = max(1.0, float(ref.float().abs().max())) if relative else 1.0
    max_err, mean_err = errors(out, ref)
    lse_err = errors(lse, ref_lse)[0] if lse is not None else 0.0
    if dtype == torch.float32:
        ok = (max_err <= (QUANT_FP32_REL if relative else FP32_ATOL) * scale
              and lse_err <= FP32_ATOL)
    else:
        ok = (max_err <= BF16_MAX_ABS * scale and mean_err <= BF16_MEAN_ABS * scale
              and lse_err <= 1e-2)
    log(f"  {name} {label} {str(dtype)[6:]} check max_abs={max_err:.3e} mean_abs={mean_err:.3e}"
        + (f" lse_max_abs={lse_err:.3e}" if lse is not None else "")
        + (f" (output scale {scale:.3g})" if relative else "") + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version in {dtype} ({label})")
    if iters == 0:
        return None
    del ref, ref_lse
    ms = cuda_ms(run, iters)
    if plain_iters > 1:
        plain_ms = cuda_ms(plain, plain_iters - 1, warmup=0)
    torch.cuda.empty_cache()
    library_ms = cuda_ms(library, iters)
    bound_ms, bound_by = bound(nb, ops, ops_type)
    log(f"  {name} {label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by}; {nb / 1e6:.2f} MB, {ops / 1e9:.3f} G ops)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_kernels(dev, seed):
    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    # shapes of the 7B main path: 2 rows of 447 spliced tokens (396 and 375
    # valid), 2 images of 25 windows of 14x14, 64x64 global grid
    results = {
        "flash_attention": check_kernel(
            "flash_attention", k1_case(dev, bf16, 2, 32, 447, 128, [396, 375], gen), bf16, 50, 3,
            "7B prefill"),
        "sam_window_attention_packed": check_kernel(
            "sam_window_attention_packed", k2_case(dev, bf16, 50, 16, 80, 14, gen), bf16, 20, 3,
            "ViT-H windows"),
        "sam_flash_attention": check_kernel(
            "sam_flash_attention", k3_case(dev, bf16, 2, 16, 64, 64, 80, gen), bf16, 5, 1,
            "ViT-H global"),
    }
    torch.cuda.empty_cache()
    f32 = torch.float32
    ragged = lambda name, case: check_kernel(name, case, f32, 0, 1, "ragged")
    ragged("flash_attention", k1_case(dev, f32, 2, 3, 70, 128, [70, 59], gen))
    ragged("flash_attention", k1_case(dev, f32, 2, 2, 37, 20, [37, 30], gen))
    ragged("sam_window_attention_packed", k2_case(dev, f32, 3, 2, 80, 14, gen))
    ragged("sam_window_attention_packed", k2_case(dev, f32, 5, 3, 20, 3, gen))
    ragged("sam_flash_attention", k3_case(dev, f32, 2, 2, 5, 7, 20, gen))
    ragged("sam_flash_attention", k3_case(dev, f32, 1, 2, 16, 16, 80, gen))
    return results


def flat_cache(dev, gen, b, l, n_kv, d, pack4):
    """One layer of a flat quantized cache, written by the port's own
    quantizers: (values [1, B, L, width] int8, scales [1, B, n_kv, L] bf16)
    for k and for v, and the dequantized [B, n_kv, L, D] bf16 tensors."""
    out = []
    for _ in range(2):
        x = torch.randn(1, b, l, n_kv, d, generator=gen, device=dev)
        if pack4:
            q, sc = llm._quant_pack4_flat(x)
            vals = torch.cat(unpack4(q, torch.float32), -1).reshape(1, b, l, n_kv, d)
        else:
            q, sc = llm._quant_rows(x)
            vals, q = q, q.flatten(-2)
        deq = (vals.float() * sc.float()[..., None])[0].transpose(1, 2).to(torch.bfloat16)
        out += [q.contiguous(), sc.transpose(2, 3).contiguous(), deq]
    return out


def k4_case(dev, dtype, b, h, n_kv, d, l, valid, pack4, gen):
    kq, ks, kd, vq, vs, vd = flat_cache(dev, gen, b, l, n_kv, d, pack4)
    q = torch.randn(b, h * d, generator=gen, device=dev).to(dtype)
    mask = torch.arange(l, device=dev)[None].expand(b, l) < valid
    mask = mask.contiguous()
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, valid_len=valid)
    run = lambda: fa.decode_attention_q(q, kq, ks, vq, vs, mask, **kw)
    plain = lambda: fa.decode_attention_q_reference(q, kq, ks, vq, vs, mask, **kw)
    rep = h // n_kv
    kr, vr = kd.repeat_interleave(rep, 1).to(dtype), vd.repeat_interleave(rep, 1).to(dtype)
    qh = q.view(b, h, 1, d)
    library = lambda: F.scaled_dot_product_attention(qh, kr, vr, attn_mask=mask[:, None, None])
    # the function needs the keys below valid_len (codes, scales, mask), q
    # and the output; the kernel reads whole DECODE_BLOCK blocks, which is
    # not work the function needs
    width = kq.shape[-1]
    nb = 2 * b * valid * (width + 2 * n_kv) + b * valid + 2 * q.numel() * q.element_size()
    return run, plain, library, (nb, 4.0 * b * h * d * valid, torch.int8)


def k5_case(dev, dtype, m, k, n, gen):
    w = int4.quantize_weight4(torch.randn(k, n, generator=gen, device=dev) * 0.02)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    run = lambda: int4.int4_matmul_pallas(x, w["w_p4"], w["w_scale"])
    plain = lambda: int4.int4_matmul_pallas_reference(x, w["w_p4"], w["w_scale"])
    wd = int4.dequantize4(w).to(dtype)
    library = lambda: x @ wd
    nb = nbytes(x, w["w_p4"], w["w_scale"]) + m * n * x.element_size()
    return run, plain, library, (nb, 2.0 * m * k * n, torch.bfloat16)


def mlp_case(dev, dtype, fmt, m, h, i_dim, gen):
    """K6 (fmt "int4") or K7 ("int8") on a silu MLP with random weights."""
    ws = {n: torch.randn(*shape, generator=gen, device=dev) * 0.02 for n, shape in
          (("gate", (h, i_dim)), ("up", (h, i_dim)), ("down", (i_dim, h)))}
    x = torch.randn(m, 1, h, generator=gen, device=dev).to(dtype)
    if fmt == "int4":
        p = quant.convert_mlp_int4({n: {"w": w} for n, w in ws.items()})
        run = lambda: int4.fused_mlp_int4(p, x, "silu")
        plain = lambda: int4.fused_mlp_int4_reference(p, x, "silu")
        deq = {"gate": int4.dequantize4(p["gate"]), "up": int4.dequantize4(p["up"]),
               "down": int4.dequantize_down4(p["down"])}
        ops_type = torch.bfloat16
    else:
        p = {n: quant.convert_proj({"w": w}, True) for n, w in ws.items()}
        run = lambda: int4.fused_mlp_int8(p, x, "silu")
        plain = lambda: int4.fused_mlp_int8_reference(p, x, "silu")
        deq = {n: v["w_q"].float() * v["w_scale"] for n, v in p.items()}
        ops_type = torch.int8
    wg, wu, wd = (deq[n].to(dtype) for n in ("gate", "up", "down"))
    library = lambda: (F.silu(x @ wg) * (x @ wu)) @ wd
    nb = nbytes(x, *_leaves(p)) + x.numel() * x.element_size()
    return run, plain, library, (nb, 6.0 * m * h * i_dim, ops_type)


def phase_quant_kernels(dev, seed):
    log("== phase 2b: K4-K7 against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    bf16, f32 = torch.bfloat16, torch.float32
    check = lambda name, case, dtype, iters, label: check_kernel(
        name, case, dtype, iters, 4 if iters else 1, label, relative=True)
    # shapes of the quantized paths: 2 rows; a 512-slot cache (447 prompt
    # slots + 64 steps, rounded up to DECODE_BLOCK), at step 32 of 64;
    # 7B: 32 heads of 128, packed int4; 1B: 16 heads, int8 rows
    results = {
        "decode_attention_q": check(
            "decode_attention_q", k4_case(dev, bf16, 2, 32, 32, 128, 512, 480, True, gen),
            bf16, 200, "7B int4_flat"),
        "int4_matmul_pallas": check(
            "int4_matmul_pallas", k5_case(dev, bf16, 2, 4096, 12288, gen), bf16, 100,
            "7B qkv4"),
        "fused_mlp_int4": check(
            "fused_mlp_int4", mlp_case(dev, bf16, "int4", 2, 4096, 11008, gen), bf16, 50,
            "7B mlp"),
        "fused_mlp_int8": check(
            "fused_mlp_int8", mlp_case(dev, bf16, "int8", 2, 2048, 5504, gen), bf16, 100,
            "1B mlp"),
    }
    check("decode_attention_q", k4_case(dev, bf16, 2, 16, 16, 128, 512, 480, False, gen),
          bf16, 200, "1B int8_flat")
    check("int4_matmul_pallas", k5_case(dev, bf16, 2, 4096, 32128, gen), bf16, 50, "7B lm_head")
    torch.cuda.empty_cache()
    check("decode_attention_q", k4_case(dev, f32, 3, 6, 3, 40, 96, 70, True, gen), f32, 0,
          "ragged GQA int4")
    check("decode_attention_q", k4_case(dev, f32, 2, 4, 2, 24, 64, 64, False, gen), f32, 0,
          "ragged GQA int8")
    check("int4_matmul_pallas", k5_case(dev, f32, 5, 96, 384, gen), f32, 0, "ragged")
    check("fused_mlp_int4", mlp_case(dev, f32, "int4", 3, 160, 96, gen), f32, 0, "ragged")
    check("fused_mlp_int8", mlp_case(dev, f32, "int8", 3, 160, 96, gen), f32, 0, "ragged")
    # the W8A8 product: cuBLASLt's int32 result is the CPU's, bit for bit, at
    # a decode o-proj (2 rows) and a SAM ViT-H qkv block (50 windows x 196);
    # the large one is held against the CPU on 256 of its rows
    for m, k, n in ((2, 4096, 4096), (9800, 1280, 3840)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        rows = torch.randperm(m, generator=gen, device=dev)[:256]
        got = int8_matmul(a, b)[rows].cpu()
        same = torch.equal(got, a[rows].cpu().int() @ b.cpu().int())
        log(f"  int32 product [{m}, {k}] x [{k}, {n}] on the card equals the CPU's: {same}")
        if not same:
            raise AssertionError("the int8 product on the card is not exact")
    return results


def chunk_inputs(dev, dtype, b, tc, h, n_kv, d, l, cl, pack4, gen):
    """A speculative chunk over one layer of a flat quantized cache: q [B,
    Tc, H*D], the cache (and its dequantized bf16 k, v), cache_len [B]."""
    kq, ks, kd, vq, vs, vd = flat_cache(dev, gen, b, l, n_kv, d, pack4)
    q = torch.randn(b, tc, h * d, generator=gen, device=dev).to(dtype)
    return q, (kq, ks, vq, vs), (kd, vd), torch.tensor(cl, device=dev)


def k8_case(dev, dtype, b, tc, h, n_kv, d, l, cl, pack4, gen):
    q, cache, (kd, vd), cache_len = chunk_inputs(dev, dtype, b, tc, h, n_kv, d, l, cl, pack4, gen)
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0)
    run = lambda: fa.decode_attention_q_chunk(q, *cache, cache_len, **kw)
    plain = lambda: fa.decode_attention_q_chunk_reference(q, *cache, cache_len, **kw)
    rep = h // n_kv
    kr, vr = kd.repeat_interleave(rep, 1).to(dtype), vd.repeat_interleave(rep, 1).to(dtype)
    qh = q.view(b, tc, h, d).transpose(1, 2)
    end = cache_len[:, None] + torch.arange(tc, device=dev)[None] + 1          # [B, Tc]
    mask = torch.arange(l, device=dev)[None, None, None, :] < end[:, None, :, None]
    library = lambda: F.scaled_dot_product_attention(qh, kr, vr, attn_mask=mask)
    # the function needs the codes and scales of the keys below cache_len +
    # Tc of each row, q, cache_len and the output; token t of a row attends
    # cache_len + t + 1 keys
    width = cache[0].shape[-1]
    keys = sum(c + tc for c in cl)
    nb = 2 * keys * (width + 2 * n_kv) + 2 * q.numel() * q.element_size() + 4 * b
    pairs = sum(c * tc + tc * (tc + 1) // 2 for c in cl)
    return run, plain, library, (nb, 4.0 * h * d * pairs, torch.int8)


def k8_against_k4(dev, label, b, tc, h, n_kv, d, l, cl, pack4, gen):
    """K8's token t against K4 at position cache_len + t over the same cache
    (key_mask = slot < cache_len + t + 1, valid_len its row maximum): one
    engine, so bit for bit."""
    q, cache, _, cache_len = chunk_inputs(dev, torch.bfloat16, b, tc, h, n_kv, d, l, cl, pack4,
                                          gen)
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0)
    out = fa.decode_attention_q_chunk(q, *cache, cache_len, **kw)
    pos = torch.arange(l, device=dev)[None]
    same = []
    for t in range(tc):
        end = cache_len[:, None] + t + 1
        step = fa.decode_attention_q(q[:, t].contiguous(), *cache, pos < end,
                                     valid_len=int(end.max()), **kw)
        same.append(torch.equal(out[:, t], step))
    log(f"  decode_attention_q_chunk {label}: token t equals decode_attention_q at position "
        f"cache_len + t, bit for bit, for t < {tc}: {all(same)}")
    if not all(same):
        raise AssertionError(f"K8 and K4 disagree at positions {[t for t, s in enumerate(same) if not s]}")


def k11_case(dev, dtype, b, h, n_kv, d, l, valid, gen):
    k, v = (torch.randn(1, b, l, n_kv * d, generator=gen, device=dev).to(dtype) for _ in range(2))
    q = torch.randn(b, h * d, generator=gen, device=dev).to(dtype)
    mask = (torch.arange(l, device=dev)[None] < torch.tensor(valid, device=dev)[:, None])
    run = lambda: fa.decode_attention(q, k, v, mask, n_kv=n_kv)
    plain = lambda: fa.decode_attention_reference(q, k, v, mask, n_kv=n_kv)
    rep = h // n_kv
    heads = lambda x: x[0].view(b, l, n_kv, d).transpose(1, 2).repeat_interleave(rep, 1)
    kh, vh = heads(k), heads(v)
    library = lambda: F.scaled_dot_product_attention(q.view(b, h, 1, d), kh, vh,
                                                     attn_mask=mask[:, None, None])
    # the k and v rows of the valid keys, the mask, q and the output
    nb = 2 * sum(valid) * n_kv * d * k.element_size() + mask.numel() + 2 * nbytes(q)
    return run, plain, library, (nb, 4.0 * h * d * sum(valid), torch.bfloat16)


def phase_decode_kernels(dev, seed):
    log("== phase 2c: K8 and K11 against their plain versions, K8 against K4")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    bf16, f32 = torch.bfloat16, torch.float32
    check = lambda name, case, dtype, iters, label: check_kernel(
        name, case, dtype, iters, 4 if iters else 1, label, relative=True)
    # the speculative chunk of the quantized paths: 2 rows, Tc = SPEC_K + 1
    # tokens, a 512-slot cache mid-request (cache_len 440 and 375)
    tc, cl = SPEC_K + 1, [440, 375]
    results = {
        "decode_attention_q_chunk": check(
            "decode_attention_q_chunk",
            k8_case(dev, bf16, 2, tc, 32, 32, 128, 512, cl, True, gen), bf16, 200, "7B int4_flat"),
        # the dense 7B fused_decode step: 480 of 512 slots valid
        "decode_attention": check_kernel(
            "decode_attention", k11_case(dev, bf16, 2, 32, 32, 128, 512, [480, 480], gen), bf16,
            200, 4, "7B bf16 flat"),
    }
    check("decode_attention_q_chunk", k8_case(dev, bf16, 2, tc, 16, 16, 128, 512, cl, False, gen),
          bf16, 200, "1B int8_flat")
    k8_against_k4(dev, "7B int4_flat", 2, tc, 32, 32, 128, 512, cl, True, gen)
    k8_against_k4(dev, "1B int8_flat", 2, tc, 16, 16, 128, 512, cl, False, gen)
    k8_against_k4(dev, "ragged GQA odd n_kv int4", 2, 5, 6, 3, 40, 96, [60, 11], True, gen)
    check("decode_attention_q_chunk",
          k8_case(dev, f32, 2, 5, 6, 3, 40, 96, [60, 11], True, gen), f32, 0,
          "ragged GQA odd n_kv int4")
    check("decode_attention_q_chunk",
          k8_case(dev, f32, 2, 16, 16, 2, 24, 64, [40, 5], False, gen), f32, 0,
          "ragged n_rep 8, Tc 16, int8")
    check_kernel("decode_attention", k11_case(dev, f32, 2, 6, 3, 40, 96, [90, 17], gen), f32, 0,
                 1, "ragged GQA")
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: the pipeline
# ---------------------------------------------------------------------------

def prompts(n_rows, lengths, pad_to, vocab, gen, dev):
    """Right-padded prompt ids with the <image> sentinel at position 1."""
    ids = torch.zeros((n_rows, pad_to), dtype=torch.long, device=dev)
    mask = torch.zeros((n_rows, pad_to), dtype=torch.bool, device=dev)
    for r, n in enumerate(lengths):
        ids[r, :n] = torch.randint(3, vocab - 16, (n,), generator=gen, device=dev)
        ids[r, 0] = 1                                       # BOS
        ids[r, 1] = walkgpt.IMAGE_TOKEN_INDEX
        mask[r, :n] = True
    return ids, mask


def phase_parity(dev, seed):
    log("== phase 3: demo_config fp32, kernel path against einsum path")
    cfg = demo_config()
    params = walkgpt.init(cfg, seed=seed, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    s = cfg.sam.img_size
    images = torch.randn(2, s, s, 3, generator=gen, device=dev)
    ids, mask = prompts(3, [40, 27, 33], 48, cfg.llm.vocab_size, gen, dev)
    kw = dict(images=images, input_ids=ids, attention_mask=mask,
              row_image_idx=torch.tensor([0, 1, 1], device=dev),
              pixel_hw=torch.tensor([[s, s], [s * 3 // 4, s]], device=dev),
              max_new_tokens=16, max_segs=8, device=dev)
    # random weights: [SEG] is the token the probe emits most, so the mask
    # path runs on real [SEG] states; no EOS, so all 16 steps are compared
    probe = walkgpt.generate_and_segment(params, cfg.replace(use_flash_attention=False),
                                         eos_id=-1, **kw).tokens
    vals, counts = torch.unique(probe, return_counts=True)
    cfg = cfg.replace(seg_token_id=int(vals[counts.argmax()]))
    attention = (fa.flash_attention, fa.sam_window_attention_packed, fa.sam_flash_attention)
    before = [f.launches for f in attention]
    flash = walkgpt.generate_and_segment(params, cfg.replace(use_flash_attention=True),
                                         eos_id=-1, **kw)
    launched = [f.launches - b for f, b in zip(attention, before)]
    plain = walkgpt.generate_and_segment(params, cfg.replace(use_flash_attention=False),
                                         eos_id=-1, **kw)
    same = torch.equal(flash.tokens, plain.tokens) and torch.equal(flash.lengths, plain.lengths)
    mask_err = float((flash.pred_masks - plain.pred_masks).abs().max())
    seg_same = (torch.equal(flash.seg_valid, plain.seg_valid)
                and torch.equal(flash.seg_rows, plain.seg_rows))
    log(f"  tokens identical={same} seg identical={seg_same} lengths={flash.lengths.tolist()} "
        f"segs={int(flash.seg_valid.sum())} mask max_abs={mask_err:.3e} "
        f"kernel launches={launched}")
    if not (same and seg_same and mask_err <= 1e-3 and min(launched) > 0):
        raise AssertionError("demo_config: kernel path and einsum path disagree")
    del params


def phase_parity_quant(dev, seed):
    """Each format twice: as deployed (W8A8 SAM blocks, masks held to
    QUANT_MASK_REL of their scale), and with float SAM blocks (masks held
    to 1e-3), which isolates what the W8A8 SAM codes move."""
    log("== phase 3b: demo_config fp32 in both quantized formats, the CPU against the card")
    base = demo_config().replace(use_flash_attention=True)
    for label, fmt, kv, sam8 in (("7B format", FORMAT_7B, "int4_flat", True),
                                 ("7B format, float SAM", FORMAT_7B, "int4_flat", False),
                                 ("1B format", FORMAT_1B, "int8_flat", True),
                                 ("1B format, float SAM", FORMAT_1B, "int8_flat", False)):
        cfg = base.replace(kv_quant_cache=kv)
        params = walkgpt.init_quantized(cfg, seed=seed, dtype=torch.float32, device=dev,
                                        **{**fmt, "sam_int8": sam8})
        cpu_params = to_device(params, "cpu")
        gen = torch.Generator(device=dev).manual_seed(seed + 3)
        s = cfg.sam.img_size
        images = torch.randn(2, s, s, 3, generator=gen, device=dev)
        ids, mask = prompts(3, [40, 27, 33], 48, cfg.llm.vocab_size, gen, dev)
        kw = dict(images=images, input_ids=ids, attention_mask=mask,
                  row_image_idx=torch.tensor([0, 1, 1], device=dev),
                  pixel_hw=torch.tensor([[s, s], [s * 3 // 4, s]], device=dev),
                  max_new_tokens=16, max_segs=8, eos_id=-1)
        probe = walkgpt.generate_and_segment(params, cfg, device=dev, **kw).tokens
        vals, counts = torch.unique(probe, return_counts=True)
        cfg = cfg.replace(seg_token_id=int(vals[counts.argmax()]))
        for f in KERNELS:
            f.launches = 0
        card = walkgpt.generate_and_segment(params, cfg, device=dev, **kw)
        launched = {f.__name__: f.launches for f in KERNELS if f.launches}
        t0 = time.perf_counter()
        cpu = walkgpt.generate_and_segment(cpu_params, cfg, device="cpu",
                                           **{k: to_device(v, "cpu") for k, v in kw.items()})
        cpu_s = time.perf_counter() - t0
        same = all(torch.equal(getattr(card, n).cpu(), getattr(cpu, n))
                   for n in ("tokens", "lengths", "seg_valid", "seg_rows"))
        mask_err = float((card.pred_masks.cpu() - cpu.pred_masks).abs().max())
        mask_scale = float(cpu.pred_masks.abs().max())
        feats_err = float((walkgpt.encode_sam(params, cfg, images)[0].cpu()
                           - walkgpt.encode_sam(cpu_params, cfg, images.cpu())[0]).abs().max())
        need = {"decode_attention_q"} | ({"int4_matmul_pallas", "fused_mlp_int4"}
                                         if kv == "int4_flat" else {"fused_mlp_int8"})
        limit = QUANT_MASK_REL * mask_scale if sam8 else 1e-3
        log(f"  {label}: tokens/lengths/seg identical={same} segs={int(card.seg_valid.sum())} "
            f"mask max_abs={mask_err:.3e} (mask scale {mask_scale:.3e}, limit {limit:.3e}) "
            f"SAM features max_abs={feats_err:.3e} kernel launches={launched} "
            f"(CPU run {cpu_s:.1f} s)")
        if not (same and mask_err <= limit and need <= set(launched)):
            raise AssertionError(f"demo_config {label}: the card and the CPU disagree")
        del params, cpu_params


def phase_parity_spec(dev, seed):
    """Speculative decode held against its own run on the CPU (on the card
    the chunk's products take other kernels than a decode step's, so it is
    not held against greedy there), float SAM blocks so that the masks hold
    1e-3; then fused_decode against the heads layout, both on the card.
    W8A8 LLM weights requantize every activation: a value on the edge of
    two codes can land on either side on the card and the CPU and flip a
    near-tied token (phase 3b's greedy run of the 1B format holds, but the
    chunk's K7 sums 27 rows in another order), so the 1B format's
    speculative run is reported, and the int8_flat cache is held with dense
    weights."""
    log("== phase 3c: demo_config fp32, speculative decode on the card against the CPU")
    base = demo_config().replace(use_flash_attention=True)
    for label, fmt, kv, held in (("7B format, float SAM, int4_flat", FORMAT_7B, "int4_flat", True),
                                 ("dense, int8_flat cache", None, "int8_flat", True),
                                 ("dense, heads fp32 cache", None, False, True),
                                 ("dense, heads int8 cache", None, "int8", True),
                                 ("1B format, float SAM, int8_flat", FORMAT_1B, "int8_flat", False)):
        cfg = base.replace(kv_quant_cache=kv)
        if fmt is None:
            params = walkgpt.init(cfg, seed=seed, dtype=torch.float32, device=dev)
        else:
            params = walkgpt.init_quantized(cfg, seed=seed, dtype=torch.float32, device=dev,
                                            **{**fmt, "sam_int8": False})
        cpu_params = to_device(params, "cpu")
        kw, cfg = demo_request(params, cfg, dev, seed + 4, speculative_k=SPEC_K)
        for f in KERNELS:
            f.launches = 0
        card = walkgpt.generate_and_segment(params, cfg, device=dev, **kw)
        launched = {f.__name__: f.launches for f in KERNELS if f.launches}
        t0 = time.perf_counter()
        cpu = walkgpt.generate_and_segment(cpu_params, cfg, device="cpu",
                                           **{k: to_device(v, "cpu") for k, v in kw.items()})
        cpu_s = time.perf_counter() - t0
        same = all(torch.equal(getattr(card, n).cpu(), getattr(cpu, n))
                   for n in ("tokens", "lengths", "seg_valid", "seg_rows"))
        differ = (card.tokens.cpu() != cpu.tokens).nonzero().tolist()
        mask_err = float((card.pred_masks.cpu() - cpu.pred_masks).abs().max())
        need = {"decode_attention_q_chunk"} if kv in ("int4_flat", "int8_flat") else set()
        log(f"  {label}{'' if held else ' (reported)'}: tokens/lengths/seg identical={same} "
            f"tokens differing {len(differ)} of {card.tokens.numel()} (first at [row, step] "
            f"{differ[0] if differ else None}) n_iters card {card.n_iters} cpu {cpu.n_iters} "
            f"segs={int(card.seg_valid.sum())} mask max_abs={mask_err:.3e} kernel launches="
            f"{launched} (CPU run {cpu_s:.1f} s)")
        if held and not (same and card.n_iters == cpu.n_iters and mask_err <= 1e-3):
            raise AssertionError(f"demo_config speculative {label}: the card and the CPU disagree")
        if not (need <= set(launched) and "decode_attention_q" not in launched):
            raise AssertionError(f"demo_config speculative {label}: kernels {launched}")
        del params, cpu_params
    params = walkgpt.init(base, seed=seed, dtype=torch.float32, device=dev)
    kw, cfg = demo_request(params, base, dev, seed + 5)
    heads = walkgpt.generate_and_segment(params, cfg, device=dev, **kw)
    fa.decode_attention.launches = 0
    cfg_f = cfg.replace(llm=dataclasses.replace(cfg.llm, fused_decode=True))
    fused = walkgpt.generate_and_segment(params, cfg_f, device=dev, **kw)
    same = torch.equal(heads.tokens, fused.tokens) and torch.equal(heads.seg_rows, fused.seg_rows)
    mask_err = float((heads.pred_masks - fused.pred_masks).abs().max())
    k11 = fa.decode_attention.launches
    log(f"  greedy, fused_decode against the heads layout on the card: tokens and seg identical="
        f"{same} mask max_abs={mask_err:.3e} decode_attention launches={k11}")
    if not (same and mask_err <= 1e-3 and k11 == cfg.llm.num_layers * kw["max_new_tokens"]):
        raise AssertionError("demo_config: fused_decode and the heads layout disagree")


def demo_request(params, cfg, dev, seed, **extra):
    """A demo_config request of 2 images and 3 prompt rows, 16 new tokens, no
    EOS (all steps compared), and cfg with [SEG] set to the token a probe
    run emits most, so the mask path runs on real [SEG] states."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = cfg.sam.img_size
    images = torch.randn(2, s, s, 3, generator=gen, device=dev)
    ids, mask = prompts(3, [40, 27, 33], 48, cfg.llm.vocab_size, gen, dev)
    kw = dict(images=images, input_ids=ids, attention_mask=mask,
              row_image_idx=torch.tensor([0, 1, 1], device=dev),
              pixel_hw=torch.tensor([[s, s], [s * 3 // 4, s]], device=dev),
              max_new_tokens=16, max_segs=8, eos_id=-1, **extra)
    probe = walkgpt.generate_and_segment(params, cfg, device=dev, **kw).tokens
    vals, counts = torch.unique(probe, return_counts=True)
    return kw, cfg.replace(seg_token_id=int(vals[counts.argmax()]))


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def expected_launches(cfg, params, n_new, n_iters=None):
    """Launches of each kernel per request: K1 per layer (prefill), K2/K3 per
    windowed/global SAM block. Greedy (n_iters None): per decode step and
    layer K4 (flat quantized cache) or K11 (fused_decode), K5 (fused int4
    q/k/v), K6 or K7 (int4 or W8A8 MLP); K5 for the int4 head once per token
    picked (n_new + 1). Speculative: per verify iteration and layer K8 (flat
    quantized cache), K5 and K7 at the chunk's rows (K6 takes single-token
    steps only); the head once per iteration and for the first token. The
    prefill's rows (2 x 447) are too many for the fused K5/K7 branches."""
    n_layers = cfg.llm.num_layers
    layer = params["llm"]["layers"][0]
    head4 = "w_p4" in params["llm"]["lm_head"]
    qkv4, mlp4, w8a8 = ("qkv4" in layer["attn"], int4.mlp_is_int4(layer["mlp"]),
                        int4.mlp_is_w8a8(layer["mlp"]))
    flat_q = cfg.kv_quant_cache in ("int8_flat", "int4_flat")
    counts = {
        "flash_attention": n_layers,
        "sam_window_attention_packed": cfg.sam.depth - len(cfg.sam.global_attn_indexes),
        "sam_flash_attention": len(cfg.sam.global_attn_indexes),
    }
    if n_iters is None:
        steps = n_layers * n_new
        counts.update(decode_attention_q=steps * flat_q, decode_attention_q_chunk=0,
                      decode_attention=steps * (cfg.llm.fused_decode and not cfg.kv_quant_cache),
                      int4_matmul_pallas=steps * qkv4 + (n_new + 1) * head4,
                      fused_mlp_int4=steps * mlp4, fused_mlp_int8=steps * w8a8)
    else:
        chunks = n_layers * n_iters
        counts.update(decode_attention_q=0, decode_attention_q_chunk=chunks * flat_q,
                      decode_attention=0,
                      int4_matmul_pallas=chunks * qkv4 + (n_iters + 1) * head4,
                      fused_mlp_int4=0, fused_mlp_int8=chunks * w8a8)
    return counts


def run_requests(params, cfg, kw, label, expect):
    """Two requests of generate_and_segment; every launch count is set to 0
    just before them and read just after, and each request's launches must
    equal expect(out). Random weights never emit the real [SEG] id: from the
    second request on, [SEG] is the token the first one emitted most, so the
    warm request gathers real [SEG] states (generation is unchanged).
    Returns (launches, outputs, host ms per request, cfg with that [SEG] id)."""
    for f in KERNELS:
        f.launches = 0
    outs, e2e = [], []
    for req in range(2):
        before = {f.__name__: f.launches for f in KERNELS}
        if req == 1:
            torch.cuda.reset_peak_memory_stats()
        out, ms = host_ms(lambda: walkgpt.generate_and_segment(params, cfg, **kw))
        per = {f.__name__: f.launches - before[f.__name__] for f in KERNELS}
        iters = f", n_iters {out.n_iters}" if out.n_iters is not None else ""
        log(f"  {label} request {req + 1}: {ms:.1f} ms{iters}, kernel launches {per}")
        want = expect(out)
        if per != want:
            raise AssertionError(f"{label}: launches per request {per}, expected {want}")
        outs.append(out)
        e2e.append(ms)
        vals, counts = torch.unique(out.tokens, return_counts=True)
        cfg = cfg.replace(seg_token_id=int(vals[counts.argmax()]))
    launches = {f.__name__: f.launches for f in KERNELS}
    log(f"  {label}: requests 1 and 2 give identical tokens: "
        f"{torch.equal(outs[0].tokens, outs[1].tokens)}")
    return launches, outs, e2e, cfg


def check_outputs(label, out, cfg, n_new, hw):
    s = cfg.sam.img_size
    final = walkgpt.finalize_masks(out.pred_masks, hw, hw)
    ok = (out.tokens.shape == (2, n_new)
          and bool(((out.tokens >= 0) & (out.tokens < cfg.llm.vocab_size)).all())
          and out.pred_masks.shape == (16, s, s) and bool(torch.isfinite(out.pred_masks).all())
          and bool(torch.isfinite(out.mask_scores).all())
          and final.shape == (16, *hw) and bool(torch.isfinite(final).all()))
    log(f"  {label}: tokens[:, :12]={out.tokens[:, :12].tolist()} lengths={out.lengths.tolist()} "
        f"segs={int(out.seg_valid.sum())} mask_scores[:4]={out.mask_scores[:4].tolist()}")
    if not ok:
        raise AssertionError(f"{label}: outputs out of range or not finite")


def add(total, launches):
    return {k: total.get(k, 0) + launches.get(k, 0) for k in KERNEL_INFO}


def phase_slice(dev, seed, max_new_tokens, label, cfg, make_params, speculative=False,
                fused=False):
    log(f"== phase 4: {label}, random weights, two requests")
    t0 = time.perf_counter()
    params = make_params(cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"  init on the card: {n_params / 1e9:.3f} B parameters in "
        f"{(time.perf_counter() - t0):.1f} s")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    s = cfg.sam.img_size
    # prompts of 141 and 120 tokens (with the <image> sentinel), right-padded
    # to 192 -> 192 - 1 + 256 = 447 spliced tokens
    ids, mask = prompts(2, [141, 120], 192, cfg.llm.vocab_size, gen, dev)
    images = torch.randn(2, s, s, 3, generator=gen, device=dev).to(torch.bfloat16)
    hw = (768, 1024)
    kw = dict(images=images, input_ids=ids, attention_mask=mask,
              row_image_idx=torch.tensor([0, 1], device=dev),
              pixel_hw=torch.tensor([hw, hw], device=dev),
              max_new_tokens=max_new_tokens, max_segs=16, eos_id=2, device=dev)
    log(f"  max_new_tokens={max_new_tokens} (the production budget of 512 is cut to keep "
        f"the run inside its time limit), max_segs=16, kv cache "
        f"{cfg.kv_quant_cache or 'bf16 heads layout'}")
    launches, outs, e2e, cfg = run_requests(
        params, cfg, kw, "greedy", lambda out: expected_launches(cfg, params, max_new_tokens))
    peak = torch.cuda.max_memory_allocated()
    check_outputs("greedy", outs[1], cfg, max_new_tokens, hw)
    log(f"  warm request (2): end_to_end_ms={e2e[1]:.1f} "
        f"max_memory_allocated_GB={peak / 1e9:.2f}")
    # host-clock times first: once the profiler has run, launches stay slower
    walls = replay(params, cfg, kw, host_ms)[0]
    kernels = {}
    devices = replay(params, cfg, kw, lambda fn: profiled(fn, kernels),
                     prefill_timer=lambda fn: profiled(fn, {}))[0]
    request_dev = sum(devices.values())
    log("  the warm request replayed step by step through the package's functions: "
        "wall ms on the host clock (synchronised), then device ms (kernels and copies, "
        "torch.profiler) in a second replay")
    for name, wall in walls.items():
        log(f"    {name}: wall_ms={wall:.1f} device_ms={devices[name]:.1f} "
            f"device_busy={devices[name] / wall:.3f}")
    # a decode step reads every LLM weight but the embedding table once
    step_bytes = nbytes(*_leaves(params["llm"])) - nbytes(params["llm"]["embed_tokens"]["w"])
    log(f"    decode per step: wall_ms={walls['decode'] / max_new_tokens:.2f} "
        f"device_ms={devices['decode'] / max_new_tokens:.2f} "
        f"bound_ms={step_bytes / PEAK_BYTES * 1e3:.2f} (weights, {step_bytes / 1e9:.2f} GB)")
    log(f"  the request's device_ms (the second replay's phases) {request_dev:.1f}, "
        f"device_busy={request_dev / e2e[1]:.3f} of the warm request's end_to_end_ms; "
        f"top 8 of its kernels by device time:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:9.1f} ms {ms / request_dev:6.1%}  {name[:110]}")
    greedy_step = walls["decode"] / max_new_tokens
    log(f"  greedy part: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if speculative:
        launches = add(launches, phase_speculative(params, cfg, kw, greedy_step))
    if fused:
        launches = add(launches, phase_fused(params, cfg, kw, walls, devices))
    log(f"  {'speculative' if speculative else 'fused_decode'} part: "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_speculative(params, cfg, kw, greedy_step):
    """Two requests with speculative_k=SPEC_K (prompt-lookup drafts; random
    weights accept almost none), their decode replayed on the host clock and
    under the profiler, then the schedule at force_accept 0 and SPEC_K
    without EOS (every iteration emits exactly force_accept + 1 tokens)."""
    n_new = kw["max_new_tokens"]
    skw = {**kw, "speculative_k": SPEC_K}
    launches, outs, e2e, cfg = run_requests(
        params, cfg, skw, f"speculative_k={SPEC_K}",
        lambda out: expected_launches(cfg, params, n_new, out.n_iters))
    check_outputs("speculative", outs[1], cfg, n_new, (768, 1024))
    walls, res = replay(params, cfg, kw, host_ms, speculative_k=SPEC_K)
    devices = replay(params, cfg, kw, lambda fn: profiled(fn, {}), speculative_k=SPEC_K)[0]
    it, emitted = res.n_iters, int(res.lengths.max())
    log(f"  speculative warm request (2): end_to_end_ms={e2e[1]:.1f}; replayed decode: "
        f"n_iters={it} emitted={res.lengths.tolist()} wall_ms={walls['decode']:.1f} "
        f"device_ms={devices['decode']:.1f} device_busy={devices['decode'] / walls['decode']:.3f}")
    log(f"    per iteration: wall_ms={walls['decode'] / it:.2f} "
        f"device_ms={devices['decode'] / it:.2f}; per emitted token (longest row): "
        f"wall_ms={walls['decode'] / emitted:.2f} against greedy's wall_ms per step "
        f"{greedy_step:.2f}")
    for accept in (0, SPEC_K):
        res, wall = schedule(params, cfg, kw, accept, host_ms)
        _, dev_ms = schedule(params, cfg, kw, accept, lambda fn: profiled(fn, {}))
        wall, dev_ms = wall - walls["prefill"], dev_ms - devices["prefill"]
        log(f"  force_accept={accept}: n_iters={res.n_iters} tokens per iteration "
            f"{n_new / res.n_iters:.2f}; per emitted token wall_ms={wall / n_new:.2f} "
            f"device_ms={dev_ms / n_new:.2f} (decode wall_ms={wall:.1f} device_ms={dev_ms:.1f})")
        if res.n_iters != -(-n_new // (accept + 1)) or res.lengths.tolist() != [n_new] * 2:
            raise AssertionError(f"force_accept={accept}: {res.n_iters} iterations, "
                                 f"lengths {res.lengths.tolist()}")
    return launches


def phase_fused(params, cfg, kw, walls_heads, devices_heads):
    """Two requests with fused_decode: the flat bf16 cache, K11 in every
    decode step and layer; the decode step against the heads layout's."""
    n_new = kw["max_new_tokens"]
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, fused_decode=True))
    launches, outs, e2e, cfg = run_requests(
        params, cfg, kw, "fused_decode", lambda out: expected_launches(cfg, params, n_new))
    check_outputs("fused_decode", outs[1], cfg, n_new, (768, 1024))
    walls = replay(params, cfg, kw, host_ms)[0]
    devices = replay(params, cfg, kw, lambda fn: profiled(fn, {}))[0]
    log(f"  fused_decode warm request (2): end_to_end_ms={e2e[1]:.1f}; decode per step: "
        f"wall_ms={walls['decode'] / n_new:.2f} device_ms={devices['decode'] / n_new:.2f} "
        f"device_busy={devices['decode'] / walls['decode']:.3f} (heads layout: wall_ms="
        f"{walls_heads['decode'] / n_new:.2f} device_ms={devices_heads['decode'] / n_new:.2f})")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def profiled(fn, kernels):
    """fn under torch.profiler, tracing the card only (no host-side op
    events to collect): (out, ms the card spent in kernels and copies);
    each kernel's device time is added to `kernels` by name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out, _ = host_ms(fn)
    device = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
            device += ms
    if device <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return out, device


@torch.inference_mode()
def replay(params, cfg, kw, timer, speculative_k=0, prefill_timer=None):
    """The steps of generate_and_segment one by one; timer(fn) -> (out, ms)
    times each (prefill_timer, when given, the standalone prefill, which
    the decode's own run repeats). Returns ({phase: ms}, the decode's
    GenerateResult): "decode" is the decode's run less the prefill."""
    flash_fn = lambda q, k, v, kv: fa.flash_attention(q, k, v, True, key_valid=kv)
    (feats, sam_tokens), enc = timer(lambda: walkgpt.encode_sam(params, cfg, kw["images"]))
    sp, spl = timer(lambda: spliced(params, cfg, kw, sam_tokens))
    b, t, _ = sp.embeds.shape
    kv = cfg.kv_quant_cache or ""
    layout, quant, _ = generate._cache_layout(cfg.llm, kv, t,
                                              cfg.llm.fused_decode and not speculative_k)

    def prefill():
        cache = llm.init_kv_cache(cfg.llm, b, t, dtype=sp.embeds.dtype, device=sp.embeds.device,
                                  quant=quant, layout=layout)
        return llm.forward(params["llm"], cfg.llm, sp.embeds, attention_mask=sp.attention_mask,
                           kv_cache=cache, flash_fn=flash_fn)
    _, pre = (prefill_timer or timer)(prefill)
    gen_kw = dict(max_new_tokens=kw["max_new_tokens"], eos_id=kw["eos_id"], flash_fn=flash_fn,
                  kv_quant=kv)
    if speculative_k:
        hist = torch.where(kw["attention_mask"] & (kw["input_ids"] >= 0), kw["input_ids"], -2)
        res, gen = timer(lambda: generate.speculative_generate(
            params["llm"], cfg.llm, sp.embeds, sp.attention_mask, draft_k=speculative_k,
            prompt_ids=hist, **gen_kw))
    else:
        res, gen = timer(lambda: generate.greedy_generate(
            params["llm"], cfg.llm, sp.embeds, sp.attention_mask, **gen_kw))

    def masks():
        valid, rows, emb = walkgpt._seg_gather(params, cfg, res.tokens, res.pred_hidden,
                                               kw["max_segs"])
        return walkgpt.decode_seg_masks(params, cfg, feats, emb, kw["row_image_idx"][rows],
                                        kw["pixel_hw"])
    _, mask = timer(masks)
    return {"encode": enc, "msqp_splice": spl, "prefill": pre, "decode": gen - pre,
            "mask_decode": mask}, res


def spliced(params, cfg, kw, sam_tokens):
    vis = walkgpt.visual_tokens(params, cfg, sam_tokens)[kw["row_image_idx"]]
    return walkgpt.splice_visual(params, cfg, kw["input_ids"], vis,
                                 attention_mask=kw["attention_mask"])


@torch.inference_mode()
def schedule(params, cfg, kw, accept, timer):
    """speculative_generate over the request's spliced prompt at a fixed
    acceptance (force_accept), without EOS: timer's (GenerateResult, ms)."""
    sp = spliced(params, cfg, kw, walkgpt.encode_sam(params, cfg, kw["images"])[1])
    return timer(lambda: generate.speculative_generate(
        params["llm"], cfg.llm, sp.embeds, sp.attention_mask,
        max_new_tokens=kw["max_new_tokens"], eos_id=-1, draft_k=SPEC_K, force_accept=accept,
        flash_fn=lambda q, k, v, kv: fa.flash_attention(q, k, v, True, key_valid=kv),
        kv_quant=cfg.kv_quant_cache or ""))


def ptxas_summary(logs):
    """Registers and spills of each library's kernels, from ptxas -v."""
    for name, text in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  {name}: {len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores {spills} bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log("== phase 1: device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(logs) if logs else 'all cached'})")
    ptxas_summary(logs)
    # parity phases compare fp32 arithmetic: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    numbers = phase_kernels(dev, args.seed)
    torch.cuda.empty_cache()
    numbers.update(phase_quant_kernels(dev, args.seed))
    torch.cuda.empty_cache()
    numbers.update(phase_decode_kernels(dev, args.seed))
    torch.cuda.empty_cache()
    phase_parity(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_quant(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_spec(dev, args.seed)
    torch.cuda.empty_cache()
    quantized = lambda fmt: (lambda c: walkgpt.init_quantized(
        c, seed=args.seed, dtype=torch.bfloat16, device=dev, **fmt))
    # the production options of the JAX package's bench.py: the SAM window
    # attention's fast path (a no-op under the kernels) and tanh GELU
    prod = dict(fast_windowed_attention=True, fast_gelu=True)
    # each path: its greedy requests, then speculative or fused_decode ones
    paths = (
        ("WalkGPT-7B, bf16", walkgpt_7b_config(),
         lambda c: walkgpt.init(c, seed=args.seed, dtype=torch.bfloat16, device=dev),
         dict(fused=True)),
        ("WalkGPT-7B int4x + int4_flat + int8 SAM",
         walkgpt_7b_config().replace(kv_quant_cache="int4_flat", **prod), quantized(FORMAT_7B),
         dict(speculative=True)),
        ("WalkGPT-1B w8a8 + int8_flat + int8 SAM",
         flagship_1b_config().replace(kv_quant_cache="int8_flat", **prod), quantized(FORMAT_1B),
         dict(speculative=True)),
    )
    launches = dict.fromkeys(KERNEL_INFO, 0)
    for label, cfg, make, extra in paths:
        t0 = time.perf_counter()
        launches = add(launches, phase_slice(dev, args.seed, args.max_new_tokens, label, cfg,
                                             make, **extra))
        torch.cuda.empty_cache()
        log(f"  {label}: phase {time.perf_counter() - t0:.1f} s")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main paths never launched: {launches}")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name], **numbers[name]})
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
