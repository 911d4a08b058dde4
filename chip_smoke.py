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
     launched (the 7B format also with fused_layer: K12, no K4 or K6);
     masks within 1e-3 with float SAM blocks, and within 2% of
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
     requests with fused_decode (K11 in every step and layer); b then two
     with fused_layer (K12 in every greedy step and layer, K4 and K6 never),
     its decode step beside the unfused one.
  2e (after 2d): K12 (fused_layer_tail) at the 7B int4x decode step and at
     an int8_flat gelu shape, K13a (quantize_tokens, bit for bit) and K13b
     (w8a8_gemm) at the four products of a ViT-H block, against their plain
     versions, with times (K12's beside the unfused sequence K4, a8 o-proj,
     rms_norm, K6; K13b's beside torch._int_mm on the same codes).
  4d (after 4): WalkGPT-1B's W8A8 SAM blocks (one windowed, one global) on
     the encoder's own activations: K13a's codes against nn.linear's, K13b
     against nn.linear's W8A8 path.
  2d (after 2c): the backward kernels K1b (flash_attention_bwd), K2b
     (sam_window_attention_packed_bwd) and K3b (sam_flash_attention_bwd)
     against their plain backwards at the training step's shapes in bf16
     and at ragged shapes in fp32 (fully masked rows, D = 80), with kernel,
     plain and library (SDPA backward) times and the bound.
  3d (after 3c): demo_config in fp32 with LoRA r=8, two train_steps and one
     qlora_train_step (int8 attention, int4 MLP, int8 SAM blocks) on the card
     and on the CPU: loss terms within LOSS_RTOL, trainable leaves within
     LEAF_RTOL / LEAF_ATOL, frozen leaves bit-identical; the SAM encoder's
     parameter gradients through K2b/K3b against the einsum path.
  5. (after 4) WalkGPT-7B training, random weights, the batch of
     train_cli.py's defaults (2 images at 1024^2, 2 rows of 512 tokens, 767
     spliced, 16 [SEG], max_segs 32): the LoRA recipe in bf16 for 3 steps
     (the last with remat), the QLoRA base for 2 steps, with loss terms,
     gradient norm, wall and device ms, tokens/s, peak memory and launches
     per step (held exactly); then one backward through the ViT-H encoder
     with respect to its rel-pos tables (K2b in 28 blocks, K3b in 4).
Then one JSON line with every kernel's numbers and, last, the device line.
Needs one CUDA GPU and nvcc (CUDA_HOME or /usr/local/cuda); exits non-zero
without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from walkgpt_tpu_torch.core.config import demo_config, flagship_1b_config, walkgpt_7b_config
from walkgpt_tpu_torch.core import nn
from walkgpt_tpu_torch.core.nn import int8_matmul, unpack4
from walkgpt_tpu_torch.core.tree import leaves_with_path, map_with_path
from walkgpt_tpu_torch.models import llm, sam_encoder, walkgpt
from walkgpt_tpu_torch.ops import cuda_build, fused_layer, int4, int8_gemm, quant
from walkgpt_tpu_torch.ops import flash_attention as fa
from walkgpt_tpu_torch.runtime import generate, lora, train

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, int8 tensor
# cores, fp32 outside the tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
KERNELS = fa.KERNELS + int4.KERNELS + fused_layer.KERNELS + int8_gemm.KERNELS
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
# training, card against CPU in fp32: the loss terms within 1e-5 relative
# (another summation order in every stage); the trainable leaves after the
# steps within the JAX package's own tolerance between two of its steps
# (tests/test_qlora.py:88), rtol 2e-4 / atol 2e-6, except that Adam divides
# each gradient by its own magnitude: an element whose gradient is within
# a few last-place steps of zero may move by any amount up to 2 lr (the
# sign of its step), so at most LEAF_OUTLIERS of the elements may lie
# outside that tolerance, and none by more than 2 lr
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 2e-4, 2e-6
LEAF_OUTLIERS = 1e-6
# K12 rounds x2, the normed row and the MLP's intermediate to bf16 inside, in
# fp32 models too, so its output takes the bf16 bounds relative to its
# largest magnitude whatever x's dtype. Its attention rows take K4's fp32
# bound (QUANT_FP32_REL); their o-proj codes, computed from the kernel's and
# the plain version's rows (sums in another order), may differ by one where
# a row lands on the edge of a code: at most K12_CODE_FLIPS of them.
K12_CODE_FLIPS = 1e-2
# K13b against nn.linear's W8A8 path on the same codes: K13b adds the bias
# and applies the activation in fp32 and rounds to bf16 once; nn.linear and
# nn.mlp round the product, then the bias sum, then (fc1) the activation,
# whose slope reaches 1.13. A rounding to bf16 moves a value by up to 2^-8
# of it, so the two may differ by about (1 + 3 * 1.13) * 2^-8 = 1.7% of the
# product's largest magnitude: held to 2% (max) and 0.1% (mean).
W8A8_BLOCK_REL, W8A8_BLOCK_MEAN = 2e-2, 1e-3

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
    "flash_attention_bwd": ("walkgpt_tpu_torch/csrc/flash_attention_bwd.cu",
                            "walkgpt_tpu/ops/flash_attention.py:243"),
    "sam_window_attention_packed_bwd": ("walkgpt_tpu_torch/csrc/sam_window_attention_bwd.cu",
                                        "walkgpt_tpu/ops/flash_attention.py:984"),
    "sam_flash_attention_bwd": ("walkgpt_tpu_torch/csrc/sam_flash_attention_bwd.cu",
                                "walkgpt_tpu/ops/flash_attention.py:641"),
    "fused_layer_tail": ("walkgpt_tpu_torch/csrc/fused_layer.cu",
                         "walkgpt_tpu/ops/fused_layer.py:67"),
    "quantize_tokens": ("walkgpt_tpu_torch/csrc/int8_gemm.cu",
                        "walkgpt_tpu/ops/int8_gemm.py:66"),
    "w8a8_gemm": ("walkgpt_tpu_torch/csrc/int8_gemm.cu", "walkgpt_tpu/ops/int8_gemm.py:136"),
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
    return dict(max_abs_err=max_err, **measure(f"{name} {label}", run, plain, library,
                                               (nb, ops, ops_type), iters, plain_iters,
                                               plain_ms))


def measure(title, run, plain, library, cost, iters, plain_iters, plain_ms):
    """Kernel, plain and library ms per call (CUDA events; library None
    where no one PyTorch call computes the function) and the bound, logged
    under `title`. plain_ms: the plain version's first (host-clock) call,
    kept when plain_iters <= 1."""
    nb, ops, ops_type = cost
    ms = cuda_ms(run, iters)
    if plain_iters > 1:
        plain_ms = cuda_ms(plain, plain_iters - 1, warmup=0)
    torch.cuda.empty_cache()
    library_ms = cuda_ms(library, iters) if library is not None else None
    bound_ms, bound_by = bound(nb, ops, ops_type)
    lib = f"{library_ms:.4f}" if library_ms is not None else "none"
    log(f"  {title}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
        f"bound_ms={bound_ms:.4f} ({bound_by}; {nb / 1e6:.2f} MB, {ops / 1e9:.3f} G ops)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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
# phase 2d: the backward kernels at the training path's shapes
# ---------------------------------------------------------------------------

def _leaf_inputs(*xs):
    return [x.detach().clone().requires_grad_() for x in xs]


def _library_bwd(fn, inputs, g):
    """A closure timing one PyTorch backward of fn's output (its graph built
    once) with respect to inputs: the library yardstick of a backward."""
    leaves = _leaf_inputs(*inputs)
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def k1b_case(dev, dtype, b, h, n, d, lengths, gen, masked_prefix=0):
    """K1b at [B, H, N, D], causal; row r's keys below masked_prefix (row 1
    only) and at or past lengths[r] invalid."""
    q, k, v, g = (torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype) for _ in range(4))
    pos = torch.arange(n, device=dev)[None]
    kv = pos < torch.tensor(lengths, device=dev)[:, None]
    kv[1, :masked_prefix] = False
    out, lse = fa.flash_attention(q, k, v, True, kv, return_lse=True)
    args = (q, k, v, True, kv, out, lse, g)
    mask = (pos[0][None, :] <= pos[0][:, None])[None, None] & kv[:, None, None, :]
    library = _library_bwd(lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c,
                                                                           attn_mask=mask),
                           (q, k, v), g)
    pairs = int(mask.sum()) * h                # (query, valid key) pairs the data needs
    nb = nbytes(q, k, v, kv, out, lse, g) + 3 * nbytes(q)
    return (lambda: fa.flash_attention_bwd(*args), lambda: fa.flash_attention_bwd_reference(*args),
            library, (nb, 10.0 * d * pairs, dtype))


def k2b_case(dev, dtype, bw, h, d, ws, gen):
    t, c = ws * ws, h * d
    qkv = torch.randn(bw, t, 3 * c, generator=gen, device=dev).to(dtype)
    rel = torch.randn(bw, t, 2 * h * ws, generator=gen, device=dev).to(dtype)
    g = torch.randn(bw, t, c, generator=gen, device=dev).to(dtype)
    out, lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    args = (qkv, rel, h, d, ws, out, lse, g)
    heads = lambda x, w: x.reshape(bw, t, h, w).transpose(1, 2).contiguous()
    key = torch.arange(t, device=dev)
    bias = (heads(rel[..., :h * ws], ws)[..., key // ws]
            + heads(rel[..., h * ws:], ws)[..., key % ws]).to(dtype)
    library = _library_bwd(lambda a, bb, cc: F.scaled_dot_product_attention(a, bb, cc,
                                                                            attn_mask=bias),
                           [heads(qkv[..., i * c:(i + 1) * c], d) for i in range(3)], heads(g, d))
    nb = nbytes(qkv, rel, out, lse, g) + nbytes(qkv, rel)
    return (lambda: fa.sam_window_attention_packed_bwd(*args),
            lambda: fa.sam_window_attention_packed_bwd_reference(*args), library,
            (nb, 10.0 * d * t * t * bw * h, dtype))


def k3b_case(dev, dtype, b, h, gh, gw, d, gen):
    n = gh * gw
    q, k, v, g = (torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype) for _ in range(4))
    rel_h = torch.randn(b, h, n, gh, generator=gen, device=dev).to(dtype)
    rel_w = torch.randn(b, h, n, gw, generator=gen, device=dev).to(dtype)
    out, lse = fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    args = (q, k, v, rel_h, rel_w, (gh, gw), out, lse, g)
    key = torch.arange(n, device=dev)
    bias = rel_h[..., key // gw] + rel_w[..., key % gw]      # [B, H, N, N], built once
    library = _library_bwd(lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c,
                                                                           attn_mask=bias),
                           (q, k, v), g)
    nb = nbytes(q, k, v, rel_h, rel_w, out, lse, g) + nbytes(q, k, v, rel_h, rel_w)
    return (lambda: fa.sam_flash_attention_bwd(*args),
            lambda: fa.sam_flash_attention_bwd_reference(*args), library,
            (nb, 10.0 * d * n * n * b * h, dtype))


def check_backward(name, case, dtype, iters, plain_iters, label):
    """A backward kernel's gradients against its plain backward on the same
    inputs, each gradient's error relative to its largest magnitude (at
    least 1): the sums run over up to N terms in another order. fp32 within
    FP32_ATOL, bf16 within BF16_MAX_ABS (max) and BF16_MEAN_ABS (mean).
    Then (iters > 0) the wrapper's ms per call (its two launches and the
    plain-torch delta), the plain backward's, the library's, and the bound
    (bytes: every input read once, every output written once; operations:
    five products of 2*D per (query, valid key) pair)."""
    run, plain, library, (nb, ops, ops_type) = case
    got = run()
    torch.cuda.synchronize()
    want, plain_ms = host_ms(plain)
    worst, ok = 0.0, True
    for i, (a, w) in enumerate(zip(got, want)):
        scale = max(1.0, float(w.float().abs().max()))
        max_err, mean_err = errors(a, w)
        worst = max(worst, max_err)
        good = bool(torch.isfinite(a.float()).all()) and (
            max_err <= FP32_ATOL * scale if dtype == torch.float32 else
            max_err <= BF16_MAX_ABS * scale and mean_err <= BF16_MEAN_ABS * scale)
        ok &= good
        limit = FP32_ATOL * scale if dtype == torch.float32 else BF16_MAX_ABS * scale
        log(f"  {name} {label} {str(dtype)[6:]} gradient {i} {tuple(a.shape)}: "
            f"max_abs={max_err:.3e} mean_abs={mean_err:.3e} (limit {limit:.3e}) "
            f"-> {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain backward in {dtype} ({label})")
    if iters == 0:
        return None
    del want
    return dict(max_abs_err=worst, **measure(f"{name} {label}", run, plain, library,
                                             (nb, ops, ops_type), iters, plain_iters, plain_ms))


def phase_backward_kernels(dev, seed):
    log("== phase 2d: K1b-K3b against their plain backwards")
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    bf16, f32 = torch.bfloat16, torch.float32
    # the training step's shapes: 2 rows of 767 spliced tokens (the second
    # with 60 pad keys), 2 images of 25 windows of 14x14, the 64x64 grid
    results = {
        "flash_attention_bwd": check_backward(
            "flash_attention_bwd", k1b_case(dev, bf16, 2, 32, 767, 128, [767, 707], gen), bf16,
            20, 3, "7B training"),
        "sam_window_attention_packed_bwd": check_backward(
            "sam_window_attention_packed_bwd", k2b_case(dev, bf16, 50, 16, 80, 14, gen), bf16,
            10, 3, "ViT-H windows"),
        "sam_flash_attention_bwd": check_backward(
            "sam_flash_attention_bwd", k3b_case(dev, bf16, 2, 16, 64, 64, 80, gen), bf16, 3, 1,
            "ViT-H global"),
    }
    torch.cuda.empty_cache()
    ragged = lambda name, case, label: check_backward(name, case, f32, 0, 1, label)
    ragged("flash_attention_bwd", k1b_case(dev, f32, 2, 3, 70, 128, [70, 59], gen, 5),
           "ragged, fully masked rows")
    ragged("flash_attention_bwd", k1b_case(dev, f32, 2, 2, 37, 80, [37, 30], gen), "ragged D=80")
    ragged("sam_window_attention_packed_bwd", k2b_case(dev, f32, 3, 2, 80, 14, gen), "ragged")
    ragged("sam_window_attention_packed_bwd", k2b_case(dev, f32, 5, 3, 20, 3, gen), "ragged")
    ragged("sam_flash_attention_bwd", k3b_case(dev, f32, 2, 2, 5, 7, 20, gen), "ragged")
    ragged("sam_flash_attention_bwd", k3b_case(dev, f32, 1, 2, 16, 16, 80, gen), "ragged")
    return results


# ---------------------------------------------------------------------------
# phase 2e: the fused decode-layer tail (K12) and the W8A8 GEMM (K13a/b)
# ---------------------------------------------------------------------------

def int4_mlp(dev, gen, h, i_dim, act):
    """A random int4 MLP in the packed format: gate/up/down (silu) or
    fc1/fc2 (gelu)."""
    ws = {n: torch.randn(*shape, generator=gen, device=dev) * 0.02 for n, shape in
          (("gate", (h, i_dim)), ("up", (h, i_dim)), ("down", (i_dim, h)))}
    p = quant.convert_mlp_int4({n: {"w": w} for n, w in ws.items()})
    return p if act == "silu" else {"fc1": p["gate"], "fc2": p["down"]}


def check_k12(dev, gen, label, b, h, d, l, valid, pack4, i_dim, act, dtype, iters):
    """K12 against its plain version at one layer of a decode step (MHA, h
    heads of d, a flat quantized cache of l slots, `valid` of them valid):
    the output within the bf16 bounds of its largest magnitude, the
    attention rows (row 0 of the wrapper's scratch [attention rows, x2, y,
    partials], of which the result is row 2) within QUANT_FP32_REL of K4's
    plain version on the same q, their o-proj codes within one and at most
    K12_CODE_FLIPS of them moved. Then (iters > 0) kernel, plain and the
    unfused sequence's ms (K4, nn.linear's a8 o-proj, rms_norm, K6: no one
    PyTorch call computes the tail, so library_ms is None), and the bound."""
    kq, ks, _, vq, vs, _ = flat_cache(dev, gen, b, l, h, d, pack4)
    hd = h * d
    q = torch.randn(b, hd, generator=gen, device=dev).to(dtype)
    mask = (torch.arange(l, device=dev)[None].expand(b, l) < valid).contiguous()
    x = (torch.randn(b, hd, generator=gen, device=dev) * 0.5).to(dtype)
    o = quant.convert_proj({"w": torch.randn(hd, hd, generator=gen, device=dev) * 0.02}, True)
    pn = (1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev)).to(dtype)
    mlp = int4_mlp(dev, gen, hd, i_dim, act)
    q8, qs = fa.banded_q8(q, n_kv=h, head_dim=d)
    kw = dict(n_kv=h, head_dim=d, pack4=pack4, layer=0, act=act, norm_eps=1e-6, valid_len=valid)
    cache = (kq, ks, vq, vs)
    run = lambda: fused_layer.fused_layer_tail(x, q8, qs, *cache, mask, o, pn, mlp, **kw)
    plain = lambda: fused_layer.fused_layer_tail_reference(x, q8, qs, *cache, mask, o, pn, mlp,
                                                           **kw)
    y = run()
    torch.cuda.synchronize()
    ref, plain_ms = host_ms(plain)
    scale = max(1.0, float(ref.abs().max()))
    max_err, mean_err = errors(y, ref)
    att = fa.decode_attention_q_reference(q.float(), *cache, mask, n_kv=h, head_dim=d,
                                          pack4=pack4, layer=0, valid_len=valid)
    att_k = y._base[0]
    att_err = float((att_k - att).abs().max()) / max(1.0, float(att.abs().max()))

    def codes(a):
        sr = a.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
        return torch.clamp(torch.round(a / sr), -127, 127)
    moved = (codes(att_k) - codes(att)).abs()
    ok = (max_err <= BF16_MAX_ABS * scale and mean_err <= BF16_MEAN_ABS * scale
          and att_err <= QUANT_FP32_REL and float(moved.max()) <= 1
          and float((moved > 0).float().mean()) <= K12_CODE_FLIPS)
    log(f"  fused_layer_tail {label} {str(dtype)[6:]} check max_abs={max_err:.3e} "
        f"mean_abs={mean_err:.3e} (output scale {scale:.3g}); attention rows max_rel="
        f"{att_err:.3e}; o-proj codes moved {int((moved > 0).sum())} of {moved.numel()} "
        f"(max {int(moved.max())}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_layer_tail disagrees with its plain version ({label})")
    if iters == 0:
        return None

    def unfused():
        a = fa.decode_attention_q(q, *cache, mask, n_kv=h, head_dim=d, pack4=pack4, layer=0,
                                  valid_len=valid)
        x2 = x + nn.linear(o, a)
        return x2 + int4.fused_mlp_int4(mlp, nn.rms_norm({"scale": pn}, x2, eps=1e-6), act)
    width = kq.shape[-1]
    nb = (nbytes(x, q8, qs, o["w_q"], o["w_scale"], pn, *_leaves(mlp))
          + 2 * b * valid * (width + 2 * h) + b * valid + 4 * b * hd)
    n_mat = 3 if act == "silu" else 2
    ops = 4.0 * b * hd * valid + 2.0 * b * hd * hd + 2.0 * n_mat * b * hd * i_dim
    res = measure(f"fused_layer_tail {label}", run, plain, None, (nb, ops, torch.bfloat16),
                  iters, 4, plain_ms)
    res["unfused_ms"] = cuda_ms(unfused, iters)
    log(f"  fused_layer_tail {label}: the unfused sequence on the card (K4, a8 o-proj, "
        f"rms_norm, K6) unfused_ms={res['unfused_ms']:.4f}")
    return dict(max_abs_err=max_err, **res)


def check_k13(dev, gen, label, m, k, n, bias, act, dtype, iters):
    """K13a bit for bit and K13b against their plain versions at one
    product [m, k] x [k, n] of a ViT-H block (random x and weights in the
    W8A8 format); K13b within one bf16 step (fp32: rtol 1e-6) of the output
    (erff / tanhf last places). Then (iters > 0) both kernels' numbers: K13a
    has no one-call library counterpart, K13b's is torch._int_mm on the same
    codes (the int32 product only, no quantize, scales, bias or activation)."""
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = quant.convert_proj({"w": torch.randn(k, n, generator=gen, device=dev) * 0.02}, True)
    b = torch.randn(n, generator=gen, device=dev) * 0.1 if bias else None
    qrun = lambda: int8_gemm.quantize_tokens(x)
    qplain = lambda: int8_gemm.quantize_tokens_reference(x)
    grun = lambda: int8_gemm.w8a8_gemm(x, w["w_q"], w["w_scale"], b, act=act)
    gplain = lambda: int8_gemm.w8a8_gemm_reference(x, w["w_q"], w["w_scale"], b, act=act)
    (xq, sx), y = qrun(), grun()
    torch.cuda.synchronize()
    (wq, ws), qplain_ms = host_ms(qplain)
    want, gplain_ms = host_ms(gplain)
    same = torch.equal(xq, wq) and torch.equal(sx, ws)
    max_err, mean_err = errors(y, want)
    scale = float(want.float().abs().max())
    tol = (1e-6 if dtype == torch.float32 else 2.0 ** -8) * scale
    ok = same and max_err <= tol
    log(f"  quantize_tokens / w8a8_gemm {label} {str(dtype)[6:]}: codes and scales identical="
        f"{same}; output max_abs={max_err:.3e} mean_abs={mean_err:.3e} (limit {tol:.3e}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K13a/K13b disagree with their plain versions ({label})")
    if iters == 0:
        return None, None
    del want
    library = lambda: torch._int_mm(xq, w["w_q"])
    qcost = (nbytes(x) + m * k + 4 * m, 4.0 * m * k, torch.float32)
    gcost = (nbytes(x, w["w_q"], w["w_scale"], *([b] if bias else [])) + m * n * x.element_size(),
             2.0 * m * k * n, torch.int8)
    return (dict(max_abs_err=0.0, **measure(f"quantize_tokens {label}", qrun, qplain, None,
                                            qcost, iters, 4, qplain_ms)),
            dict(max_abs_err=max_err, **measure(f"w8a8_gemm {label}", grun, gplain, library,
                                                gcost, iters, 4, gplain_ms)))


def phase_tail_gemm_kernels(dev, seed):
    log("== phase 2e: K12, K13a and K13b against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    bf16, f32 = torch.bfloat16, torch.float32
    # K12 at the 7B int4x decode step of phase 4b: 2 rows, 32 heads of 128, a
    # 512-slot int4_flat cache with 480 valid, I 11008, silu; then the
    # int8_flat cache with the gelu MLP at a narrow shape
    results = {"fused_layer_tail": check_k12(dev, gen, "7B int4x", 2, 32, 128, 512, 480, True,
                                             11008, "silu", bf16, 100)}
    check_k12(dev, gen, "int8_flat gelu", 2, 8, 128, 256, 200, False, 2816, "gelu", bf16, 20)
    check_k12(dev, gen, "ragged", 3, 5, 24, 64, 40, True, 384, "silu", f32, 0)
    check_k12(dev, gen, "ragged int8 gelu", 2, 2, 8, 16, 16, False, 96, "gelu", f32, 0)
    torch.cuda.empty_cache()
    # the four products of a ViT-H block for 2 images at 1024^2: a windowed
    # block's qkv and proj take 2 x 25 windows of 14 x 14 (the 64 x 64 grid
    # padded to 70 x 70): 9800 rows; the MLP (and a global block) 8192 rows
    for label, m, k, n, bias, act in (("ViT-H qkv", 9800, 1280, 3840, True, None),
                                      ("ViT-H proj", 9800, 1280, 1280, False, None),
                                      ("ViT-H fc1", 8192, 1280, 5120, True, "gelu_exact"),
                                      ("ViT-H fc2", 8192, 5120, 1280, False, None)):
        qres, gres = check_k13(dev, gen, label, m, k, n, bias, act, bf16, 20)
        if label == "ViT-H fc1":
            results.update(quantize_tokens=qres, w8a8_gemm=gres)
        torch.cuda.empty_cache()
    check_k13(dev, gen, "ragged", 37, 96, 20, True, "gelu_tanh", f32, 0)
    check_k13(dev, gen, "ragged bf16", 130, 256, 388, True, "gelu_tanh", bf16, 0)
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
    for label, fmt, kv, sam8, fuse in (
            ("7B format", FORMAT_7B, "int4_flat", True, False),
            ("7B format, float SAM", FORMAT_7B, "int4_flat", False, False),
            ("7B format, float SAM, fused_layer", FORMAT_7B, "int4_flat", False, True),
            ("1B format", FORMAT_1B, "int8_flat", True, False),
            ("1B format, float SAM", FORMAT_1B, "int8_flat", False, False)):
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
                  max_new_tokens=16, max_segs=8, eos_id=-1, fused_layer=fuse)
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
        if fuse:        # K12 in every step and layer, in place of K4 and K6
            need = {"int4_matmul_pallas", "fused_layer_tail"}
            if {"decode_attention_q", "fused_mlp_int4"} & set(launched):
                raise AssertionError(f"demo_config {label}: K4 or K6 ran: {launched}")
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


def expected_launches(cfg, params, n_new, n_iters=None, fuse=False):
    """Launches of each kernel per request: K1 per layer (prefill), K2/K3 per
    windowed/global SAM block. Greedy (n_iters None): per decode step and
    layer K4 (flat quantized cache) or K11 (fused_decode), K5 (fused int4
    q/k/v), K6 or K7 (int4 or W8A8 MLP); K5 for the int4 head once per token
    picked (n_new + 1). With fuse (generate_and_segment's fused_layer) over
    a flat quantized cache, a layer that layer_tail_supported accepts (every
    layer of the int4x format) runs K12 in place of K4 and K6, and K5 still
    takes its fused q/k/v. Speculative: per verify iteration and layer K8
    (flat quantized cache), K5 and K7 at the chunk's rows (K6 takes
    single-token steps only); the head once per iteration and for the first
    token. The prefill's rows (2 x 447) are too many for the fused K5/K7
    branches. K13a/K13b run in no request."""
    n_layers = cfg.llm.num_layers
    layer = params["llm"]["layers"][0]
    head4 = "w_p4" in params["llm"]["lm_head"]
    qkv4, mlp4, w8a8 = ("qkv4" in layer["attn"], int4.mlp_is_int4(layer["mlp"]),
                        int4.mlp_is_w8a8(layer["mlp"]))
    flat_q = cfg.kv_quant_cache in ("int8_flat", "int4_flat")
    tail = fuse and flat_q and fused_layer.layer_tail_supported(layer, cfg.llm)
    counts = dict.fromkeys(KERNEL_INFO, 0)          # no backward kernel in inference
    counts.update({
        "flash_attention": n_layers,
        "sam_window_attention_packed": cfg.sam.depth - len(cfg.sam.global_attn_indexes),
        "sam_flash_attention": len(cfg.sam.global_attn_indexes),
    })
    if n_iters is None:
        steps = n_layers * n_new
        counts.update(decode_attention_q=steps * flat_q * (not tail), decode_attention_q_chunk=0,
                      decode_attention=steps * (cfg.llm.fused_decode and not cfg.kv_quant_cache),
                      int4_matmul_pallas=steps * qkv4 + (n_new + 1) * head4,
                      fused_mlp_int4=steps * mlp4 * (not tail), fused_mlp_int8=steps * w8a8,
                      fused_layer_tail=steps * tail)
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
                fused=False, fused_layer_tail=False):
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
    if fused_layer_tail:
        t0 = time.perf_counter()
        launches = add(launches, phase_fused_layer(params, cfg, kw, walls, devices,
                                                   outs[1].tokens, e2e[1]))
        log(f"  fused_layer part: {time.perf_counter() - t0:.1f} s")
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


def phase_fused_layer(params, cfg, kw, walls_unfused, devices_unfused, tokens_unfused,
                      e2e_unfused):
    """Two requests with fused_layer: K12 in every greedy step and layer (K4
    and K6 never), launch counts held exactly; the decode step's wall,
    device ms and busy share beside the unfused step of the same run."""
    n_new = kw["max_new_tokens"]
    fkw = {**kw, "fused_layer": True}
    launches, outs, e2e, cfg = run_requests(
        params, cfg, fkw, "fused_layer",
        lambda out: expected_launches(cfg, params, n_new, fuse=True))
    check_outputs("fused_layer", outs[1], cfg, n_new, (768, 1024))
    walls = replay(params, cfg, kw, host_ms, fused_layer=True)[0]
    kernels = {}
    devices = replay(params, cfg, kw, lambda fn: profiled(fn, kernels), fused_layer=True)[0]
    same = torch.equal(outs[1].tokens, tokens_unfused)
    log(f"  fused_layer warm request (2): end_to_end_ms={e2e[1]:.1f} (unfused {e2e_unfused:.1f}); "
        f"tokens identical to the unfused greedy request's: {same}")
    log(f"    decode per step: fused wall_ms={walls['decode'] / n_new:.2f} "
        f"device_ms={devices['decode'] / n_new:.2f} "
        f"device_busy={devices['decode'] / walls['decode']:.3f}; unfused wall_ms="
        f"{walls_unfused['decode'] / n_new:.2f} device_ms={devices_unfused['decode'] / n_new:.2f} "
        f"device_busy={devices_unfused['decode'] / walls_unfused['decode']:.3f}")
    request_dev = sum(devices.values())
    log(f"  the fused request's device_ms {request_dev:.1f}; top 5 of its kernels by device time:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"    {ms:9.1f} ms {ms / request_dev:6.1%}  {name[:110]}")
    return launches


def phase_w8a8_blocks(dev, seed):
    """WalkGPT-1B's W8A8 SAM blocks through K13a and K13b: the quantized
    parameters of the first windowed and the first global ViT-H block (random
    weights from the seed, the 1B format's quantizer), the encoder's own
    activations for 2 images at 1024^2 (blocks run in order up to the global
    one). Each of the two blocks' four products (qkv, proj, fc1 with its
    exact gelu, fc2): K13a's codes and scales equal nn.linear's (bit for
    bit), and K13b's output is nn.linear's W8A8 path within W8A8_BLOCK_REL
    (max) and W8A8_BLOCK_MEAN (mean) of its largest magnitude. Every launch
    count is set to 0 here and read at the end."""
    log("== phase 4d: WalkGPT-1B W8A8 ViT-H blocks through K13a and K13b")
    cfg = flagship_1b_config().sam
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    enc = quant.quantize_sam_encoder(
        {"image_encoder": sam_encoder.init(g, cfg, dtype=torch.bfloat16)},
        act_quant=True)["image_encoder"]
    images = torch.randn(2, cfg.img_size, cfg.img_size, 3, generator=g, device=dev)
    glob = cfg.global_attn_indexes[0]
    linear = nn.linear
    products = []

    def record(p, x):
        y = linear(p, x)
        products.append((p, x, y))
        return y
    for f in KERNELS:
        f.launches = 0
    with torch.inference_mode():
        x = nn.conv2d(enc["patch_embed"], images.to(torch.bfloat16),
                      stride=(cfg.patch_size, cfg.patch_size), padding="VALID")
        x = x + enc["pos_embed"].to(x.dtype)
        for i, blk in enumerate(enc["blocks"][:glob + 1]):
            if i in (0, glob):
                nn.linear = record
            try:
                x = sam_encoder._block(blk, x, cfg, 0 if i == glob else cfg.window_size, True)
            finally:
                nn.linear = linear
        if len(products) != 8:
            raise AssertionError(f"expected 8 W8A8 products, recorded {len(products)}")
        names = ("qkv", "proj", "fc1", "fc2")
        ok = True
        for j, (p, xin, y) in enumerate(products):
            label = f"{'windowed' if j < 4 else 'global'} block {names[j % 4]}"
            act = "gelu_exact" if names[j % 4] == "fc1" else None
            want = nn.gelu_exact(y) if act else y
            xq, sx = int8_gemm.quantize_tokens(xin)
            wq, ws = nn.quantize_a8(xin)
            got = int8_gemm.w8a8_gemm(xin, p["w_q"], p["w_scale"], p.get("b"), act=act)
            scale = float(want.float().abs().max())
            max_err, mean_err = errors(got, want)
            same = torch.equal(xq, wq) and torch.equal(sx, ws)
            good = (same and max_err <= W8A8_BLOCK_REL * scale
                    and mean_err <= W8A8_BLOCK_MEAN * scale)
            ok &= good
            log(f"  {label} x {tuple(xin.shape)} @ {tuple(p['w_q'].shape)}: K13a codes equal "
                f"nn.linear's={same}; K13b against nn.linear max_rel={max_err / scale:.3e} "
                f"mean_rel={mean_err / scale:.3e} -> {'ok' if good else 'FAIL'}")
    launches = {f.__name__: f.launches for f in KERNELS}
    log(f"  launches: {_nonzero(launches)}")
    if not (ok and launches["quantize_tokens"] == 8 and launches["w8a8_gemm"] == 8):
        raise AssertionError("W8A8 ViT-H blocks: K13a/K13b disagree with nn.linear")
    return launches


# ---------------------------------------------------------------------------
# phases 3d and 5: training
# ---------------------------------------------------------------------------

def train_batch(cfg, dev, gen, lengths, row_len, answer, segs, max_segs, hw, dtype):
    """A training batch as train_cli.py's collate gives it: one image per
    row, rows right-padded to row_len with the <image> sentinel at 1,
    labels on each row's answer span (its last `answer` real tokens), which
    holds `segs` [SEG] tokens, and random binary gt_masks [max_segs, S, S]
    (the first sum(segs) real). Built here, without the JAX package."""
    rows = len(lengths)
    ids, mask = prompts(rows, lengths, row_len, cfg.llm.vocab_size, gen, dev)
    labels = torch.full_like(ids, walkgpt.IGNORE_INDEX)
    for r, n in enumerate(lengths):
        span = torch.arange(n - answer, n, device=dev)
        seg_pos = span[torch.randperm(answer, generator=gen, device=dev)[:segs]]
        ids[r, seg_pos] = cfg.seg_token_id
        labels[r, n - answer:n] = ids[r, n - answer:n]
    s = cfg.sam.img_size
    return dict(images=torch.randn(rows, s, s, 3, generator=gen, device=dev).to(dtype),
                input_ids=ids, labels=labels, attention_mask=mask,
                row_image_idx=torch.arange(rows, device=dev),
                gt_masks=torch.rand(max_segs, s, s, generator=gen, device=dev) > 0.5,
                pixel_hw=torch.tensor([hw] * rows, device=dev))


def _leaf_errors(card, cpu):
    """Per trainable leaf: elements of the card's leaf outside
    LEAF_RTOL/LEAF_ATOL of the CPU's, and the largest difference."""
    out, worst = 0, 0.0
    for p, x in cpu.items():
        a, b = card[p].cpu().float(), x.float()
        out += int(((a - b).abs() > LEAF_ATOL + LEAF_RTOL * b.abs()).sum())
        worst = max(worst, float((a - b).abs().max()))
    return out, worst


def _frozen_snapshot(params, trainable):
    """{path: (tensor, fp32 checksum)} of the frozen tensor leaves."""
    return {p: (x, float(x.float().sum())) for p, x in leaves_with_path(params).items()
            if isinstance(x, torch.Tensor) and p not in trainable}


def _frozen_same(snap, params):
    now = leaves_with_path(params)
    return all(now[p] is x and float(x.float().sum()) == c for p, (x, c) in snap.items())


def phase_parity_train(dev, seed):
    """demo_config in fp32: two train_steps and one qlora_train_step on the
    card (K1, K1b and the SAM kernels) and on the CPU (plain versions), from
    the same weights and batch; then the SAM encoder's parameter gradients,
    kernel path (K2b, K3b) against einsum path, on the card.

    InfoNCE's top-k refinement (nce_topk 8) keeps the 8 most attended SAM
    tokens: a hard selection, discontinuous where the 8th and 9th weights
    tie. On an H100 at this seed a 1e-5 difference of the SAM features
    (another summation order) moves one token across it in the QLoRA step
    (nce 1.3156 on the card, 1.3063 on the CPU). The steps compared here run
    without it (nce_topk None); the loss with it is reported beside them, it
    is held against JAX on the CPU (tests/test_torch_losses.py), and phase 5
    trains with it."""
    log("== phase 3d: demo_config fp32 training, the card against the CPU")
    topk_cfg = demo_config().replace(use_flash_attention=True)
    cfg = topk_cfg.replace(losses=dataclasses.replace(topk_cfg.losses, nce_topk=None))
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    params = walkgpt.init(cfg, seed=seed, dtype=torch.float32, device=dev)
    params["llm"] = lora.init_lora(params["llm"], g, r=8, alpha=16.0)
    batch = train_batch(cfg, dev, g, [60, 47], 64, 20, 4, 8, [256, 192], torch.float32)
    kw = dict(model_cfg=cfg, max_segs=8)
    runs = {}
    for where in ("card", "cpu"):
        on = dev if where == "card" else torch.device("cpu")
        p = params if where == "card" else to_device(params, "cpu")
        b = batch if where == "card" else to_device(batch, "cpu")
        for f in KERNELS:
            f.launches = 0
        state, opt = train.init_state(p, train.TrainConfig(warmup_steps=1))
        snap = _frozen_snapshot(p, opt.trainable)
        metrics = []
        for i in range(2):
            state, m = train.train_step(state, b, opt=opt, remat=i == 1, device=on, **kw)
            metrics.append({k: float(v) for k, v in m.items()})
        qp = dict(p, llm=quant.quantize_llm(p["llm"], act_quant=False, mlp_int4=True,
                                            quantize_lm_head=False),
                  sam=quant.quantize_sam_encoder(p["sam"]))
        qstate, qopt, frozen = train.init_qlora_state(qp, train.TrainConfig(warmup_steps=0))
        qsnap = _frozen_snapshot(frozen, set())
        qstate, qm = train.qlora_train_step(qstate, frozen, b, opt=qopt, device=on, **kw)
        with torch.no_grad():
            topk_nce = float(walkgpt.model_forward(
                qp, topk_cfg, max_segs=8, **walkgpt._as_inputs(on, **b)).nce_loss)
        runs[where] = dict(metrics=metrics + [{k: float(v) for k, v in qm.items()}],
                           params=state.params, qparams=qstate.params, base=qp,
                           topk_nce=topk_nce,
                           frozen=_frozen_same(snap, state.params) and _frozen_same(qsnap, frozen),
                           launches={f.__name__: f.launches for f in KERNELS if f.launches},
                           trainable=opt.trainable)
    card, cpu = runs["card"], runs["cpu"]
    loss_ok = all(abs(c[k] - w[k]) <= LOSS_RTOL * abs(w[k])
                  for c, w in zip(card["metrics"], cpu["metrics"]) for k in train.METRICS)
    for step, (c, w) in enumerate(zip(card["metrics"], cpu["metrics"])):
        log(f"  step {step + 1}{' (qlora)' if step == 2 else ''}: " + " ".join(
            f"{k}={c[k]:.6f}/{w[k]:.6f}" for k in train.METRICS + ("grad_norm",)) + " (card/CPU)")
    cp = {k: v for k, v in leaves_with_path(card["params"]).items() if k in card["trainable"]}
    wp = {k: v for k, v in leaves_with_path(cpu["params"]).items() if k in cpu["trainable"]}
    qc, qw = leaves_with_path(card["qparams"]), leaves_with_path(cpu["qparams"])
    (dense_out, dense_worst), (q_out, q_worst) = _leaf_errors(cp, wp), _leaf_errors(qc, qw)
    n_el = sum(x.numel() for x in wp.values())
    nq_el = sum(x.numel() for x in qw.values())
    bc, bw = leaves_with_path(card["base"]), leaves_with_path(cpu["base"])
    base_same = bc.keys() == bw.keys() and all(
        torch.equal(x.cpu(), bw[p]) if isinstance(x, torch.Tensor) else x == bw[p]
        for p, x in bc.items())
    lr2 = 2 * train.TrainConfig().lr
    log(f"  trainable leaves after 2 steps: {len(wp)} leaves, {n_el} elements, {dense_out} "
        f"outside rtol {LEAF_RTOL} / atol {LEAF_ATOL}, max_abs {dense_worst:.3e}; after the "
        f"qlora step: {q_out} of {nq_el} outside, max_abs {q_worst:.3e} (limits: "
        f"{LEAF_OUTLIERS:g} of the elements, max_abs {lr2:g}); QLoRA base (codes, scales) "
        f"identical on the card and the CPU: {base_same}; frozen leaves bit-identical before "
        f"and after: card {card['frozen']} CPU {cpu['frozen']}; kernel launches on the card "
        f"{card['launches']}")
    log(f"  reported: the QLoRA step's nce_loss with nce_topk 8: card {card['topk_nce']:.6f} "
        f"CPU {cpu['topk_nce']:.6f}")
    need = {"flash_attention", "flash_attention_bwd", "sam_window_attention_packed",
            "sam_flash_attention"}
    if not (loss_ok and dense_out <= LEAF_OUTLIERS * n_el and q_out <= LEAF_OUTLIERS * nq_el
            and max(dense_worst, q_worst) <= lr2 and base_same and card["frozen"]
            and cpu["frozen"] and need <= set(card["launches"]) and not cpu["launches"]):
        raise AssertionError("demo_config training: the card and the CPU disagree")

    # the SAM encoder's parameter gradients through K2b/K3b against the einsum path
    enc = {k: v for k, v in params["sam"]["image_encoder"].items()}
    x = batch["images"]
    grads = {}
    for flash in (True, False):
        leaves = {p: t.detach().clone().requires_grad_()
                  for p, t in leaves_with_path(enc).items()}
        tree = map_with_path(lambda p, t: leaves.get(p, t), enc)
        for f in KERNELS:
            f.launches = 0
        sam_encoder.apply(tree, cfg.sam, x, use_flash=flash).sum().backward()
        grads[flash] = {p: t.grad for p, t in leaves.items()}
        launched = {f.__name__: f.launches for f in KERNELS if f.launches}
        if flash:
            bwd = launched
    worst = max(float((grads[True][p] - grads[False][p]).abs().max()
                      / max(1.0, float(grads[False][p].abs().max()))) for p in grads[False])
    log(f"  SAM encoder parameter gradients, kernel path against einsum path: max relative "
        f"difference {worst:.3e} (limit 5e-4), kernel launches {bwd}")
    if not (worst <= 5e-4 and bwd.get("sam_window_attention_packed_bwd")
            and bwd.get("sam_flash_attention_bwd")):
        raise AssertionError("demo_config SAM encoder: kernel and einsum gradients disagree")


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def train_launches(cfg, remat):
    """Kernel launches of one train_step: per LLM layer K1 (twice with remat:
    the backward pass recomputes the block) and K1b; per windowed / global
    SAM block K2 / K3; the frozen encoder runs no backward."""
    n = cfg.llm.num_layers
    counts = dict.fromkeys(KERNEL_INFO, 0)
    counts.update(flash_attention=n * (2 if remat else 1), flash_attention_bwd=n,
                  sam_window_attention_packed=cfg.sam.depth - len(cfg.sam.global_attn_indexes),
                  sam_flash_attention=len(cfg.sam.global_attn_indexes))
    return counts


def run_train_steps(label, cfg, state, batch, step_fn, remats, tokens, kernels):
    """Steps on the host clock (synchronised), each with its loss terms,
    gradient norm, peak memory and launches (held to train_launches); then
    one more step without remat under the profiler, for the device time (its
    result dropped), set against step 2's wall. Returns (the last state,
    the state after step 2)."""
    walls = []
    for i, remat in enumerate(remats):
        before = {f.__name__: f.launches for f in KERNELS}
        torch.cuda.reset_peak_memory_stats()
        (state, m), ms = host_ms(lambda: step_fn(state, batch, remat))
        walls.append(ms)
        per = {f.__name__: f.launches - before[f.__name__] for f in KERNELS}
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {label} step {i + 1}{' (remat)' if remat else ''}: "
            + " ".join(f"{k}={float(v):.5f}" for k, v in m.items())
            + f" wall_ms={ms:.1f} tokens_per_s={tokens / ms * 1e3:.1f} "
            f"max_memory_allocated_GB={peak:.2f} launches {_nonzero(per)}")
        if per != train_launches(cfg, remat) or not all(math.isfinite(float(v))
                                                         for v in m.values()):
            raise AssertionError(f"{label} step {i + 1}: launches {per} or metrics {m}")
        if i == 1:
            state2 = state
    _, dev_ms = profiled(lambda: step_fn(state, batch, False), kernels)
    log(f"  {label} step without remat under the profiler (not applied): device_ms={dev_ms:.1f}, "
        f"device_busy={dev_ms / walls[1]:.3f} of step 2's wall; top 5 kernels by device time:")
    for name, kms in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"    {kms:9.1f} ms {kms / dev_ms:6.1%}  {name[:100]}")
    return state, state2


def phase_train(dev, seed):
    """WalkGPT-7B training at full width with random weights: the
    reference's LoRA recipe in bf16 (3 steps, the last with remat), the
    QLoRA base (2 steps), and one backward through the ViT-H encoder with
    respect to its rel-pos tables. Every kernel count is set to 0 here and
    read at the end."""
    log("== phase 5: WalkGPT-7B training, random weights")
    for f in KERNELS:
        f.launches = 0
    cfg = walkgpt_7b_config()
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    t0 = time.perf_counter()
    params = walkgpt.init(cfg, seed=seed, dtype=torch.bfloat16, device=dev)
    params["llm"] = lora.init_lora(params["llm"], g, r=8, alpha=16.0)
    torch.cuda.synchronize()
    log(f"  init on the card (LoRA r=8, alpha 16 on q and v): {time.perf_counter() - t0:.1f} s")
    # train_cli.py's defaults: 2 images at 1024^2, rows of 512 tokens
    # (--seq_multiple 256) spliced to 767, 8 [SEG] per row, --max_segs 32
    batch = train_batch(cfg, dev, g, [480, 431], 512, 120, 8, 32, [1024, 768], torch.bfloat16)
    tokens = batch["input_ids"].shape[0] * (512 - 1 + cfg.visual_tokens)
    tc = train.TrainConfig(warmup_steps=1)
    state, opt = train.init_state(params, tc)
    snap = _frozen_snapshot(params, opt.trainable)
    b0 = params["llm"]["layers"][0]["attn"]["q"]["lora_b"]
    n_train = sum(x.numel() for p, x in leaves_with_path(params).items() if p in opt.trainable)
    log(f"  trainable: {len(opt.trainable)} leaves, {n_train / 1e6:.1f} M parameters; "
        f"batch: 2 rows x 767 spliced tokens, 16 [SEG], max_segs 32")
    step = lambda st, b, remat: train.train_step(st, b, opt=opt, model_cfg=cfg, max_segs=32,
                                                 remat=remat, device=dev)
    state, state2 = run_train_steps("LoRA bf16", cfg, state, batch, step, (False, False, True),
                                    tokens, {})
    moved = float((state2.params["llm"]["layers"][0]["attn"]["q"]["lora_b"].float()
                   - b0.float()).abs().max())
    frozen = _frozen_same(snap, state.params)
    log(f"  LoRA bf16: lora_b (layer 0, q) moved by max {moved:.3e} after step 2; frozen base "
        f"unchanged (same tensors, same checksums): {frozen}")
    if not (moved > 0 and frozen):
        raise AssertionError("7B LoRA: lora_b did not move or the frozen base changed")

    # one backward through the full ViT-H encoder, 1 image, to its rel-pos tables
    enc = params["sam"]["image_encoder"]
    rel = {p: t.detach().clone().requires_grad_() for p, t in leaves_with_path(enc).items()
           if p.endswith(("rel_pos_h", "rel_pos_w"))}
    before = {f.__name__: f.launches for f in KERNELS}
    _, ms = host_ms(lambda: sam_encoder.apply(map_with_path(lambda p, t: rel.get(p, t), enc),
                                              cfg.sam,
                                              batch["images"][:1], use_flash=True
                                              ).float().square().mean().backward())
    per = {f.__name__: f.launches - before[f.__name__] for f in KERNELS}
    finite = all(bool(torch.isfinite(t.grad).all()) and bool(t.grad.abs().max() > 0)
                 for t in rel.values())
    log(f"  ViT-H encoder backward to its {len(rel)} rel-pos tables (1 image): wall_ms={ms:.1f}, "
        f"gradients finite and nonzero: {finite}, launches {_nonzero(per)}")
    n_glob = len(cfg.sam.global_attn_indexes)
    if not (finite and per["sam_window_attention_packed_bwd"] == cfg.sam.depth - n_glob
            and per["sam_flash_attention_bwd"] == n_glob):
        raise AssertionError(f"ViT-H encoder backward: launches {per}")
    del params, state, state2, enc, rel, snap, b0
    torch.cuda.empty_cache()

    # QLoRA: int8 attention + packed int4 MLP, dense head, weight-only int8 SAM blocks
    t0 = time.perf_counter()
    qparams = walkgpt.init_quantized(cfg, seed=seed, dtype=torch.bfloat16, device=dev,
                                     act_quant=False, mlp_int4=True, sam_int8=True,
                                     quantize_lm_head=False)
    qparams["llm"] = lora.init_lora(qparams["llm"], g, r=8, alpha=16.0)
    torch.cuda.synchronize()
    log(f"  QLoRA base built one layer at a time on the card: {time.perf_counter() - t0:.1f} s")
    qstate, qopt, frozen = train.init_qlora_state(qparams, tc)
    qsnap = _frozen_snapshot(frozen, set())
    b0 = qstate.params["llm"]["layers"][0]["attn"]["q"]["lora_b"]
    qstep = lambda st, b, remat: train.qlora_train_step(st, frozen, b, opt=qopt, model_cfg=cfg,
                                                        max_segs=32, remat=remat, device=dev)
    qstate, q2 = run_train_steps("QLoRA", cfg, qstate, batch, qstep, (False, False), tokens, {})
    moved = float((q2.params["llm"]["layers"][0]["attn"]["q"]["lora_b"].float()
                   - b0.float()).abs().max())
    frozen_ok = _frozen_same(qsnap, frozen)
    log(f"  QLoRA: lora_b (layer 0, q) moved by max {moved:.3e} after step 2; frozen base "
        f"unchanged: {frozen_ok}")
    if not (moved > 0 and frozen_ok):
        raise AssertionError("7B QLoRA: lora_b did not move or the frozen base changed")
    return {f.__name__: f.launches for f in KERNELS}


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
def replay(params, cfg, kw, timer, speculative_k=0, prefill_timer=None, fused_layer=False):
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
            params["llm"], cfg.llm, sp.embeds, sp.attention_mask, fused_layer=fused_layer,
            **gen_kw))

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
    numbers.update(phase_backward_kernels(dev, args.seed))
    torch.cuda.empty_cache()
    numbers.update(phase_tail_gemm_kernels(dev, args.seed))
    torch.cuda.empty_cache()
    phase_parity(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_quant(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_spec(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_train(dev, args.seed)
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
         dict(speculative=True, fused_layer_tail=True)),
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
    t0 = time.perf_counter()
    launches = add(launches, phase_w8a8_blocks(dev, args.seed))
    torch.cuda.empty_cache()
    log(f"  W8A8 blocks: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = add(launches, phase_train(dev, args.seed))
    log(f"  training: phase {time.perf_counter() - t0:.1f} s")
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
