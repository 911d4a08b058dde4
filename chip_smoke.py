#!/usr/bin/env python3
"""Drive the PyTorch port of WalkGPT on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--max-new-tokens 64]

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit; build the CUDA kernels
     (one nvcc per source, in parallel) and print the build time.
  2. kernels: K1 (flash_attention), K2 (sam_window_attention_packed) and K3
     (sam_flash_attention) against their plain versions at the shapes the
     WalkGPT-7B main path gives them (K1 also at the serving admit and the
     training forward, in bf16 at ragged tiles, on rows that see no valid
     key, and against float64 products of its own p, SPLIT_GAIN times
     closer than p rounded to bf16 alone); K4 (decode_attention_q), K5
     (int4_matmul_pallas), K6 (fused_mlp_int4) and K7 (fused_mlp_int8) at
     the shapes of the quantized 7B and 1B paths (K5 and K7 also at 4 and
     18 rows, K5 at 1 row and the 13B qkv4, K7 at a 7B-width W8A8 MLP),
     K5, K6 and K7 also at the server's pool of 4 rows, each row of which
     must equal the row called alone, and a second call the first, bit for
     bit (K4's rows and the decode step's RMSNorm the same way, logged,
     not held; and the decode step's token pick, argmax over fp32 logits,
     at a planted exact tie in every row at 1, 4 and 8 rows, each row
     against the row alone, logged), and K4's chunk engine against its walk
     route bit for bit
     (7B at 2 and 4 rows, 1B, ragged GQA; int8 and bf16 scores) with its
     host microseconds per call (2b); K8
     (decode_attention_q_chunk) at the speculative chunk of both, K8's
     tokens against K4 at the same positions bit for bit, and K11
     (decode_attention) at the dense 7B fused_decode step, its bf16 engine
     (decode_flat.cuh) against its walk route bit for bit at the 7B (2 and
     4 rows), 13B and 1B steps and ragged GQA shapes (2c); all in
     bf16, and again in fp32 at small ragged shapes (K3 also in bf16 there:
     head views at D = 20, key tiles that cut grid rows, a 16 x 16 grid,
     whole grid rows per key tile at D = 40 and at gw = 128, contiguous and
     as head views; K2 also in bf16 at ws = 7 and 3, D = 20 and 64); kernel,
     plain-version and library times, and the bound. The W8A8 int32
     product on the card against the CPU's, bit for bit.
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
     within 1e-3 (the 1B format's W8A8 run is reported beside them, with
     the first int8 code on which it parts from the CPU, held to lie on a
     rounding edge); greedy with fused_decode (K11) against the heads layout
     on the card. 3e (after 3c): the continuous-batching server
     (runtime/serving.py) at demo_config over heads fp32, heads int8 and
     int8_flat pools (dense) and an int4_flat pool (7B format): six spliced
     requests through 2 slots, the card against the CPU (Finished order,
     tokens, budgets, [SEG] rows within 1e-4, masks within 1e-3), each
     request against greedy_generate of it alone.
  4. the slices at full width, random weights from --seed built on the card,
     two requests of 2 images and 2 prompt rows each, with launch counts per
     request, peak memory, the warm request's phase times on the host
     clock and on the card (torch.profiler), K1's share of the prefill's
     and the request's device time, K4's, K5's, K6's and K7's of the
     quantized greedy requests' and K8's, K5's and K7's of the speculative
     ones (beside the decode step's wall, device ms and busy share), and
     K2's and K3's share of the warm
     SAM encode's device time:
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
     its decode step beside the unfused one, then serves eight PAVE
     questions (llava_v1 prompts, byte tokenizer, 3 images encoded once)
     through the continuous batcher (4 slots, int4_flat pool, PAVE-like
     budgets), launches per admit and per segment held exactly (K1's share
     of the admits' device time, K4's, K5's and K6's of the segments'), the
     two longest requests token for token against the same request decoded
     alone with the batcher's arithmetic (alone_in_pool), and against
     greedy_generate alone (reported, not held: it decodes at a batch of
     one, whose products round otherwise), beside the same
     requests in greedy_generate waves of 4.
  2e (after 2d): K12 (fused_layer_tail) at the 7B int4x decode step (2
     and 4 rows) and at an int8_flat gelu shape, its MLP partials held to
     K6's on its own normed rows bit for bit, K13a (quantize_tokens, bit
     for bit; timed at ViT-H fc1's and fc2's inputs) and K13b
     (w8a8_gemm) at the four products of a ViT-H block and at ragged
     shapes, against their plain versions, K13b also against its first
     design (w8a8_gemm_mma_sync) bit for bit, with times (K12's beside the
     unfused sequence K4, a8 o-proj, rms_norm, K6; K13b's beside
     torch._int_mm on the same codes and its first design).
  4d (after 4): WalkGPT-1B's W8A8 SAM blocks (one windowed, one global) on
     the encoder's own activations: K13a's codes against nn.linear's, K13b
     against nn.linear's W8A8 path. 4e: K10 (sam_window_attention) on the
     first windowed ViT-H block's own activations against the block's K2
     path, and one backward through K10b against K2b's.
  2f (after 2e): K10 and K10b (split-layout window attention) against their
     plain versions at the ViT-H windowed shapes in bf16 and at ragged
     shapes in fp32 and bf16 (and a bf16 q with fp32 rel tables), against
     K2/K2b on the same values repacked (bit for bit), with kernel, plain
     and library (SDPA with the expanded bias, and its backward) times and
     the bound.
  2g (after 2f): the route each dtype takes (K1, K1b, K2, K2b, K3, K3b,
     K10, K10b: bf16, and K10b's bf16 q with fp32 rel tables, on the
     tensor-core engines, the backwards in bwd_mma_kernel or K1b's
     bwd_pair_kernel; fp32 on the CUDA-core ones), read from
     the kernels one call launches under the profiler, and held; K5, K6, K7,
     K8, K4 (7B and 1B, int8 scores), K11 (bf16), K13b (K % 16 == 0), K12
     and K13a launch their own engines' kernels (mlp4_stream.cuh, K7's three
     passes, decode_chunk.cuh, decode_flat.cuh, K13b's quantize, transpose
     and wgmma kernels, K12's one cooperative kernel, K13a's one-pass
     quantize_rows) and none of those they left (K5's, K7's and K13b's
     first designs; decode_walk.cuh, which K4 keeps for its int8 value
     product); K11's fp32 cache and K13b at K % 16 != 0 the first ones.
     Then K12 (7B, 2 and 4 rows; with its launch's blocks, registers,
     spills and shared memory, and the same launch with every phase empty)
     and K13a (ViT-H fc1 and fc2 inputs) alone, by the profiler.
  2d (after 2c): the backward kernels K1b (flash_attention_bwd), K2b
     (sam_window_attention_packed_bwd) and K3b (sam_flash_attention_bwd)
     against their plain backwards at the training step's shapes in bf16
     and at ragged shapes in fp32 (fully masked rows, D = 80), K1b also in
     bf16 at ragged shapes (N = 70, 37, 130; D = 128, 80, 64, 20; the fully
     masked rows' dq exactly 0), K2b also in bf16 at ragged windows (ws =
     3, 5, 7, 14; D = 16, 20, 80; odd BW * H), K3b also in bf16 at K3's
     ragged shapes; K1b, K2b and K3b twice on the main path's inputs
     (bit-identical gradients); kernel, plain and library (SDPA backward)
     times and the bound; K1b's, K2b's and K3b's dq, dk and dv against
     float64 products of their own p and ds, SPLIT_GAIN times closer than p
     and ds rounded to bf16 alone.
  3d (after 3c): demo_config in fp32 with LoRA r=8, two train_steps and one
     qlora_train_step (int8 attention, int4 MLP, int8 SAM blocks) on the card
     and on the CPU: loss terms within LOSS_RTOL, trainable leaves within
     LEAF_RTOL / LEAF_ATOL, frozen leaves bit-identical; the SAM encoder's
     parameter gradients through K2b/K3b against the einsum path.
  5. (after 4) WalkGPT-7B training, random weights, the batch of
     train_cli.py's defaults (2 images at 1024^2, 2 rows of 512 tokens, 767
     spliced, 16 [SEG], max_segs 32): the LoRA recipe in bf16 for 3 steps
     (the last with remat), the QLoRA base for 2 steps, with loss terms,
     gradient norm, wall and device ms (K1's, K1b's and K2's share of it), tokens/s,
     peak memory and launches per step (held exactly); then one backward through the ViT-H encoder
     with respect to its rel-pos tables (K2b in 28 blocks, K3b in 4),
     and the same backward warm under the profiler (device ms, and K2's,
     K3's, K2b's and K3b's shares, by problem name).
  6. (after 5) the PAVE evaluation entry point: a synthetic manifest (16
     samples, 24 questions, .pt label maps of 480 x 640 with several class
     ids and 255 pixels, no frames: the dataset's dummy images), then
     a. runtime/evaluate.main at WalkGPT-7B int4x (--quant int4x --kv_cache
        int4_flat --sam_quant int8 --precision bf16, 2 images a batch, 64
        new tokens, random weights from seed 0) on all 16 samples (8
        batches, so that the median batch is a steady rate): the native
        preprocessing library loaded, the metric line's keys, one response
        per question in the "Question: ... | Answer: ..." form, K1-K6
        launched and no plain version called; images/s, steady images/s,
        count_params;
     b. the CLI's first batch: its tokens against generate_and_segment
        called directly on the same inputs (and replayed warm under the
        profiler, which must show K1-K6's kernels; walls, device ms and
        busy shares of both passes) and with precomputed_sam from
        encode_sam, bit for bit; device_mask_counts against the host's
        intersection_and_union on the read-back canvases, exactly; each
        real row decoded alone for 16 steps (logged);
     c. the CLI's SAM encoder (int8 blocks) in the block_runs layout
        against the blocks layout on one 1024^2 image, bit for bit;
     d. validate at demo_config in the same format (fp32) on the card and
        on the CPU, the first 4 samples, 16 new tokens: every batch's
        generated tokens and lengths equal in the rows of its questions
        (the padding rows of the row bucket, which nothing reads, logged),
        and identical responses;
        per-mask counts equal once the pixels whose logit lies within the
        mask tolerance of 0 on either side are left out (their number
        printed);
     e. the CLIP stream: runtime/evaluate.main --visual_stream clip at
        WalkGPT-7B int4x (6a's flags, CLIP ViT-L/14-448) on 4 samples, 64
        new tokens: 6a's keys and response checks, K1-K6 launched and no
        plain version called, images/s; then generate_and_segment(
        visual_stream="clip") at demo_config in the 7B int4x format, the
        card against the CPU: identical tokens, lengths and [SEG] rows.
  7. (after 6) the training entry point, runtime/train_cli.main:
     a. at WalkGPT-7B full width (--model_size 7b --precision bf16
        --dataset PAVE --lora_r 8 --batch_size 2 --epochs 1
        --steps_per_epoch 3 --eval_samples 2, its defaults otherwise) on a
        synthetic manifest, random weights from seed 0; the free bytes of
        the temporary directory and the state's and best checkpoint's
        bytes reckoned from the tree first (1b instead only if the disk
        cannot hold both); held: every train/* and metrics/* tag finite
        for steps 1-3, the val/* tags, `latest` naming global_step3 and
        its state loading back bit for bit, the projector artifact
        reloading through evaluate.build_model --projector_ckpt, the LoRA
        adapters and trained groups moved and every frozen leaf (the CLIP
        tower included) unchanged bit for bit, K1, K1b, K2 and K3 launched
        and no plain version called; s/step (median of steps 2-3), peak
        memory, each checkpoint's bytes and save seconds, the state's load
        seconds, count_params;
     b. at demo_config in fp32 (TF32 off), the card against --device cpu
        from one checkpoint: the LoRA leg (2 steps, then --auto_resume
        --epochs 2 for 2 more) and the QLoRA leg (--quant_base int4x, 2
        steps, --no_eval): the losses of every step within LOSS_RTOL and
        the trainable leaves at the end within phase 3d's tolerance (the
        steps with nce_topk None, for 3d's reason).
  8. (after 7b) parity_cli record at demo_config in the 7B int4x format
     on the card and on the CPU from 7b's checkpoint, 3 samples of 16
     tokens: compare returns 0 (identical tokens, masks within gIoU 1e-3).
Then one JSON line with every kernel's numbers and, last, the device line.
Needs one CUDA GPU and nvcc (CUDA_HOME or /usr/local/cuda); exits non-zero
without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from walkgpt_tpu_torch.core.config import (LossWeights, demo_config, flagship_1b_config,
                                            walkgpt_7b_config)
from walkgpt_tpu_torch.core import config as config_module
from walkgpt_tpu_torch.core import nn
from walkgpt_tpu_torch.core.nn import int8_matmul, unpack4
from walkgpt_tpu_torch.core.tree import leaves_with_path, map_with_path
from walkgpt_tpu_torch.data import conversation, native_loader, pave, tokenizer
from walkgpt_tpu_torch.eval import metrics as eval_metrics
from walkgpt_tpu_torch.models import llm, sam, sam_encoder, walkgpt
from walkgpt_tpu_torch.models.projectors import ctp_apply
from walkgpt_tpu_torch.ops import attention, cuda_build, fused_layer, int4, int8_gemm, quant
from walkgpt_tpu_torch.ops import flash_attention as fa
from walkgpt_tpu_torch.runtime import (checkpoint, evaluate, generate, lora, parity_cli,
                                       serving, train, train_cli)
from walkgpt_tpu_torch.tools import synthetic_pave

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
# K1b's, K2b's and K3b's dq, dk and dv against float64 products of their
# own fp32 p and ds (all rounded to bf16): the kernel's mean error stays
# this many times under that of rounding p and ds to bf16 alone
# (k1b_split_check, k2b_split_check, k3b_split_check)
SPLIT_GAIN = 8
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
# serving over the flat quantized pools, card against CPU in fp32: the
# cache rows are int8 or int4 codes (15 levels) and K4 quantizes each query
# head to int8 codes and rounds p and alpha to bf16 inside, so an fp32
# last-place difference upstream that meets a code or a bf16 edge moves a
# cache row or an attention row by a code or a bf16 step, and the [SEG]
# hidden states (the final norm's output) by up to about 1% of their
# largest magnitude from there on (phase 3e: 4.4e-3 over int8_flat and
# 2.7e-2 over int4_flat at a scale of 3.2-3.4, tokens identical, masks
# within 5.1e-5): held within 1e-2 of that magnitude; the heads-layout
# pools hold 1e-4.
SERVE_FLAT_HIDDEN_REL = 1e-2

KERNEL_INFO = {
    "flash_attention": ("walkgpt_tpu_torch/csrc/flash_attention.cu",
                        "walkgpt_tpu/ops/flash_attention.py:51",
                        ["walkgpt_tpu_torch/csrc/attention_mma.cuh",
                         "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "sam_window_attention_packed": ("walkgpt_tpu_torch/csrc/sam_window_attention.cu",
                                    "walkgpt_tpu/ops/flash_attention.py:958",
                                    ["walkgpt_tpu_torch/csrc/attention_mma.cuh",
                                     "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "sam_flash_attention": ("walkgpt_tpu_torch/csrc/sam_flash_attention.cu",
                            "walkgpt_tpu/ops/flash_attention.py:372",
                            ["walkgpt_tpu_torch/csrc/attention_mma.cuh",
                             "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "decode_attention_q": ("walkgpt_tpu_torch/csrc/decode_attention_q.cu",
                           "walkgpt_tpu/ops/flash_attention.py:1327",
                           ["walkgpt_tpu_torch/csrc/decode_chunk.cuh",
                            "walkgpt_tpu_torch/csrc/decode_walk.cuh"]),
    "int4_matmul_pallas": ("walkgpt_tpu_torch/csrc/int4_matmul.cu",
                           "walkgpt_tpu/ops/int4.py:463",
                           ["walkgpt_tpu_torch/csrc/mlp4_stream.cuh",
                            "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "fused_mlp_int4": ("walkgpt_tpu_torch/csrc/fused_mlp_int4.cu",
                       "walkgpt_tpu/ops/int4.py:105",
                       ["walkgpt_tpu_torch/csrc/mlp4_stream.cuh",
                        "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "fused_mlp_int8": ("walkgpt_tpu_torch/csrc/fused_mlp_int8.cu",
                       "walkgpt_tpu/ops/int4.py:351",
                       ["walkgpt_tpu_torch/csrc/dp4a_quads.cuh",
                        "walkgpt_tpu_torch/csrc/mlp4_stream.cuh",
                        "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "decode_attention_q_chunk": ("walkgpt_tpu_torch/csrc/decode_attention_q.cu",
                                 "walkgpt_tpu/ops/flash_attention.py:1519",
                                 ["walkgpt_tpu_torch/csrc/decode_chunk.cuh",
                                  "walkgpt_tpu_torch/csrc/decode_walk.cuh"]),
    "decode_attention": ("walkgpt_tpu_torch/csrc/decode_attention.cu",
                         "walkgpt_tpu/ops/flash_attention.py:1154",
                         ["walkgpt_tpu_torch/csrc/decode_flat.cuh",
                          "walkgpt_tpu_torch/csrc/decode_walk.cuh"]),
    "flash_attention_bwd": ("walkgpt_tpu_torch/csrc/flash_attention_bwd.cu",
                            "walkgpt_tpu/ops/flash_attention.py:243",
                            ["walkgpt_tpu_torch/csrc/attention_mma_bwd.cuh",
                             "walkgpt_tpu_torch/csrc/attention_mma.cuh",
                             "walkgpt_tpu_torch/csrc/attention_bwd.cuh"]),
    "sam_window_attention_packed_bwd": ("walkgpt_tpu_torch/csrc/sam_window_attention_bwd.cu",
                                        "walkgpt_tpu/ops/flash_attention.py:984",
                                        ["walkgpt_tpu_torch/csrc/attention_mma_bwd.cuh",
                                         "walkgpt_tpu_torch/csrc/attention_mma.cuh",
                                         "walkgpt_tpu_torch/csrc/attention_bwd.cuh"]),
    "sam_flash_attention_bwd": ("walkgpt_tpu_torch/csrc/sam_flash_attention_bwd.cu",
                                "walkgpt_tpu/ops/flash_attention.py:641",
                                ["walkgpt_tpu_torch/csrc/attention_mma_bwd.cuh",
                                 "walkgpt_tpu_torch/csrc/attention_mma.cuh",
                                 "walkgpt_tpu_torch/csrc/attention_bwd.cuh"]),
    "fused_layer_tail": ("walkgpt_tpu_torch/csrc/fused_layer.cu",
                         "walkgpt_tpu/ops/fused_layer.py:67",
                         ["walkgpt_tpu_torch/csrc/decode_chunk.cuh",
                          "walkgpt_tpu_torch/csrc/mlp4_stream.cuh",
                          "walkgpt_tpu_torch/csrc/dp4a_quads.cuh"]),
    "quantize_tokens": ("walkgpt_tpu_torch/csrc/int8_gemm.cu",
                        "walkgpt_tpu/ops/int8_gemm.py:66"),
    "w8a8_gemm": ("walkgpt_tpu_torch/csrc/int8_gemm.cu", "walkgpt_tpu/ops/int8_gemm.py:136"),
    "sam_window_attention": ("walkgpt_tpu_torch/csrc/sam_window_attention_split.cu",
                             "walkgpt_tpu/ops/flash_attention.py:777",
                             ["walkgpt_tpu_torch/csrc/attention_mma.cuh",
                              "walkgpt_tpu_torch/csrc/attention_tile.cuh"]),
    "sam_window_attention_bwd": ("walkgpt_tpu_torch/csrc/sam_window_attention_split_bwd.cu",
                                 "walkgpt_tpu/ops/flash_attention.py:800",
                                 ["walkgpt_tpu_torch/csrc/attention_mma_bwd.cuh",
                                  "walkgpt_tpu_torch/csrc/attention_mma.cuh",
                                  "walkgpt_tpu_torch/csrc/attention_bwd.cuh"]),
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


def k1_masked_rows(dev, gen):
    """K1's bf16 route on rows that see no valid key (row 1's first 5 keys
    invalid, causal): every logit such a row sees is the finite -1e30, so
    the kernel gives it p = 1 for each key of the 64-key tiles it visits
    (the CUDA-core engine's function): out is the mean of v over keys 0 ..
    63, finite, within the bf16 bounds, and lse about -1e30. The other rows
    are held to the plain version within the bf16 bounds."""
    n, d, dead = 70, 128, 5
    q, k, v = (torch.randn(2, 2, n, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kv = torch.ones(2, n, dtype=torch.bool, device=dev)
    kv[1, :dead] = False
    out, lse = fa.flash_attention(q, k, v, True, kv, return_lse=True)
    ref = fa.flash_attention_reference(q, k, v, True, kv)[0]
    live = torch.ones(2, n, dtype=torch.bool, device=dev)
    live[1, :dead] = False
    live = live[:, None].expand(-1, 2, -1)
    err = (out.float() - ref.float())[live].abs()
    mean = v[1, :, :64].float().mean(1, keepdim=True)
    err_dead = float((out[1, :, :dead].float() - mean).abs().max())
    ok = (bool(torch.isfinite(out.float()).all()) and float(err.max()) <= BF16_MAX_ABS
          and float(err.mean()) <= BF16_MEAN_ABS and err_dead <= BF16_MAX_ABS
          and bool((lse[1, :, :dead] <= -1e29).all()))
    log(f"  flash_attention bf16 rows with no valid key: finite, the mean of v over the keys of "
        f"their tile (max_abs={err_dead:.3e}), lse {float(lse[1, :, :dead].max()):.3e}; the "
        f"other rows against the plain version max_abs={float(err.max()):.3e} "
        f"mean_abs={float(err.mean()):.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention: rows with no valid key, or the others, are wrong")


def k1_products(q, k, v, kv, lse, single):
    """out from K1's own fp32 p (s = scale (q . k) from the bf16 operands, p
    = exp(s - lse) and exactly 0 where masked) with every value product in
    float64. single: p rounded to bf16 alone first."""
    n, d = q.shape[2], q.shape[-1]
    pos = torch.arange(n, device=q.device)
    mask = kv[:, None, None, :] & (pos[None, :] <= pos[:, None])[None, None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()).float() * (1.0 / math.sqrt(d))
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    if single:
        p = p.to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.double(), v.double())


def k1_split_check(dev, n, d, gen):
    """K1's bf16 out against the same products in float64, rounded to bf16
    as the kernel writes it, beside p rounded to bf16 alone, causal with
    padded keys (2 rows, the second without its last n // 10 keys): the
    kernel's hi + lo split keeps about 16 bits of p, so its mean error must
    stay SPLIT_GAIN times under the single-bf16 scheme's (rounding p to
    bf16 alone, as the nolo build of tools/attention_variants.py does,
    fails this)."""
    q, k, v = (torch.randn(2, 2, n, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kv = torch.arange(n, device=dev)[None] < torch.tensor([n, n - n // 10], device=dev)[:, None]
    out, lse = fa.flash_attention(q, k, v, True, kv, return_lse=True)
    exact = k1_products(q, k, v, kv, lse, single=False).to(torch.bfloat16).float()
    single = k1_products(q, k, v, kv, lse, single=True).to(torch.bfloat16).float()
    err_kernel = float((out.float() - exact).abs().mean())
    err_single = float((single - exact).abs().mean())
    ok = err_kernel * SPLIT_GAIN <= err_single
    log(f"  flash_attention split products N={n} D={d}: mean_abs against float64 products "
        f"{err_kernel:.3e}, p in bf16 alone {err_single:.3e} (ratio "
        f"{err_single / err_kernel if err_kernel else math.inf:.1f}, at least {SPLIT_GAIN}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention: the split products are not closer than bf16 alone")


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


# the route of each kernel whose bf16 inputs run the tensor-core engines
# (bf16 mma.sync; fp32 inputs stay on the CUDA-core engines, since the
# tensor cores have no exact fp32 product): the engine's header, and the
# CUDA kernels (torch.profiler names) of each route
ROUTES = {
    "flash_attention": "attention_mma.cuh / attention_tile.cuh",
    "flash_attention_bwd": "attention_mma_bwd.cuh (pair layout) / attention_bwd.cuh",
    "sam_window_attention_packed": "attention_mma.cuh / attention_tile.cuh",
    "sam_window_attention_packed_bwd": "attention_mma_bwd.cuh / attention_bwd.cuh",
    "sam_window_attention": "attention_mma.cuh / attention_tile.cuh",
    "sam_window_attention_bwd": "attention_mma_bwd.cuh / attention_bwd.cuh",
    "sam_flash_attention": "attention_mma.cuh / attention_tile.cuh",
    "sam_flash_attention_bwd": "attention_mma_bwd.cuh / attention_bwd.cuh",
}
TENSOR_CORE_KERNELS = ("attention_mma_kernel", "bwd_mma_kernel", "bwd_pair_kernel")
# the tensor-core kernel (and problem) each backward's bf16 route must launch
TENSOR_CORE_BWD = {"flash_attention_bwd": "bwd_pair_kernel<FlashBwdMma",
                   "sam_window_attention_packed_bwd": "bwd_mma_kernel<WindowBwdMma",
                   "sam_window_attention_bwd": "bwd_mma_kernel<WindowSplitBwdMma",
                   "sam_flash_attention_bwd": "bwd_mma_kernel<GlobalBwdMma"}


def phase_routes(dev, seed):
    """The route each dtype takes, read from the kernels one call launches
    under the profiler (after every kernel timing: once the profiler has
    run, launches stay slower)."""
    log("== phase 2g: the route of each tensor-core kernel, by dtype; K5's, K6's, K7's, "
        "K8's and K4's kernels")
    gen = torch.Generator(device=dev).manual_seed(seed + 50)
    dts = (torch.bfloat16, torch.float32)
    log_routes("flash_attention", {dt: k1_case(dev, dt, 2, 2, 70, 128, [70, 59], gen)[0]
                                   for dt in dts})
    log_routes("flash_attention_bwd",
               {dt: k1b_case(dev, dt, 2, 2, 70, 128, [70, 59], gen, 5)[0] for dt in dts})
    log_routes("sam_window_attention_packed",
               {dt: k2_case(dev, dt, 2, 2, 80, 14, gen)[0] for dt in dts})
    log_routes("sam_window_attention_packed_bwd",
               {dt: k2b_case(dev, dt, 2, 2, 80, 14, gen)[0] for dt in dts})
    log_routes("sam_window_attention",
               {dt: k10_case(k10_inputs(dev, dt, dt, 2, 2, 80, 14, gen), 14)[0] for dt in dts})
    log_routes("sam_window_attention_bwd",
               {dt: k10b_case(k10_inputs(dev, dt, dt, 2, 2, 80, 14, gen), 14)[0] for dt in dts})
    log_routes("sam_window_attention_bwd", {torch.bfloat16: k10b_case(
        k10_inputs(dev, torch.bfloat16, torch.float32, 2, 2, 80, 14, gen), 14)[0]},
        ", fp32 rel tables")
    log_routes("sam_flash_attention", {dt: k3_case(dev, dt, 1, 2, 8, 8, 80, gen)[0] for dt in dts})
    log_routes("sam_flash_attention_bwd",
               {dt: k3b_case(dev, dt, 1, 2, 8, 8, 80, gen)[0] for dt in dts})
    log("  K5, K6, K7, K8, K4, K11 and K13b on their own engines (the 7B qkv4, the 7B and "
        "1B decode MLPs, the 7B speculative chunk, the 7B and 1B decode steps with int8 "
        "scores, the main path's mode, the dense 7B step, a ViT-H fc1 slice):")
    log_symbols("int4_matmul_pallas", k5_case(dev, torch.bfloat16, 2, 4096, 12288, gen)[0])
    log_symbols("fused_mlp_int4", mlp_case(dev, torch.bfloat16, "int4", 2, 4096, 11008, gen)[0])
    log_symbols("fused_mlp_int8", mlp_case(dev, torch.bfloat16, "int8", 2, 2048, 5504, gen)[0])
    log_symbols("decode_attention_q_chunk",
                k8_case(dev, torch.bfloat16, 2, SPEC_K + 1, 32, 32, 128, 512, [440, 375], True,
                        gen)[0])
    for h, pack4 in ((32, True), (16, False)):
        log_symbols("decode_attention_q",
                    k4_case(dev, torch.bfloat16, 2, h, h, 128, 512, 480, pack4, gen)[0])
    log_symbols("decode_attention",
                k11_case(dev, torch.bfloat16, 2, 32, 32, 128, 512, [480, 480], gen)[0])
    log_symbols("decode_attention fp32",
                k11_case(dev, torch.float32, 2, 6, 3, 40, 96, [90, 17], gen)[0])
    log_symbols("w8a8_gemm", k13b_case(dev, gen, 256, 1280, 512, True, "gelu_exact",
                                       torch.bfloat16)[0])
    log_symbols("w8a8_gemm K % 16 != 0",
                k13b_case(dev, gen, 37, 100, 20, True, None, torch.float32)[0])
    log("  K12 at the 7B int4x step and K13a at ViT-H fc1's and fc2's inputs, kernels alone "
        "(the profiler, per call):")
    bf16 = torch.bfloat16
    for b in (2, 4):
        run, *_rest, inp = k12_case(dev, gen, b, 32, 128, 512, 480, True, 11008, "silu", bf16)
        log_symbols("fused_layer_tail", run)
        log_kernel_alone(f"fused_layer_tail 7B int4x {b} rows", run)
        info = fused_layer.fused_layer_tail_info(b, 32, 128, 512, 11008, True, bf16, bf16, dev)
        log(f"    launch: {info['blocks']} blocks ({info['blocks_per_sm']} an SM of "
            f"{info['sms']}), {info['registers']} registers and {info['local_bytes']} bytes of "
            f"local memory a thread, {info['smem']} bytes of shared memory a block, rows in "
            f"passes of {info['rows_per_pass']}")
        log_kernel_alone(f"fused_layer_tail 7B int4x {b} rows, phases empty (the four grid "
                         f"barriers)", lambda: fused_layer.fused_layer_tail_barriers(
                             *inp["args"], **inp["kw"]))
    for label, k in (("fc1", 1280), ("fc2", 5120)):
        x = torch.randn(8192, k, generator=gen, device=dev).to(bf16)
        log_symbols("quantize_tokens", lambda: int8_gemm.quantize_tokens(x))
        log_kernel_alone(f"quantize_tokens ViT-H {label} [8192, {k}] bf16",
                         lambda: int8_gemm.quantize_tokens(x))


def log_kernel_alone(label, fn, n=20):
    """The package's kernels that fn launches, device ms per call
    (torch.profiler over n calls after a warm call)."""
    fn()
    kernels = {}
    profiled(lambda: [fn() for _ in range(n)], kernels)
    ours = {k: v / n for k, v in kernels.items() if is_package_kernel(k)}
    log(f"    {label}: " + "; ".join(
        f"{k.replace('(anonymous namespace)::', '').replace('void ', '').split('(')[0]} "
        f"{v:.4f} ms" for k, v in ours.items()) + f" (total {sum(ours.values()):.4f} ms)")


def is_package_kernel(name):
    """A CUDA kernel of the package: in namespace wgt, or in a source's own
    anonymous namespace (int8_gemm.cu's)."""
    return "wgt::" in name or name.replace("void ", "").startswith("(anonymous namespace)::")


def traced_kernels(label, fn):
    """The package's CUDA kernels (torch.profiler names, namespaces and
    arguments cut) that one call of fn launches."""
    kernels = {}
    for attempt in range(3):   # a short trace may come back without device events
        try:
            profiled(fn, kernels)
            break
        except AssertionError:
            if attempt == 2:
                raise
            log(f"  {label}: the profiler saw no device time, tracing again")
    return sorted({n.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
                   for n in kernels if is_package_kernel(n)})


def log_routes(name, runs, note=""):
    """One call of each closure in runs ({dtype: fn}) under the profiler:
    logs the package's CUDA kernels it launched, and fails unless bf16 ran
    a tensor-core kernel (a backward its own, TENSOR_CORE_BWD) and fp32
    none."""
    for dtype, fn in runs.items():
        label = f"{name} {str(dtype)[6:]}{note}"
        ours = traced_kernels(label, fn)
        tc = any(k in n for n in ours for k in TENSOR_CORE_KERNELS)
        log(f"  {label} route: {'tensor cores' if tc else 'CUDA cores'} "
            f"({ROUTES[name].split(' / ')[0 if tc else 1]}): {'; '.join(ours)}")
        own = name not in TENSOR_CORE_BWD or any(TENSOR_CORE_BWD[name] in n for n in ours)
        if not ours or tc != (dtype == torch.bfloat16) or (tc and not own):
            raise AssertionError(f"{label} took the wrong route ({ours})")


# the CUDA kernels of K5's, K6's, K7's, K8's and K4's engines (mlp4_stream.cuh
# for K5 and K6, fused_mlp_int8.cu's three passes, decode_chunk.cuh), and
# those of the engines they left (K5's and K7's one-block-per-tile kernels;
# decode_walk.cuh, which K4 keeps for its int8 value product, off on the
# main path); K12's one cooperative kernel (its engines are inlined) and
# K13a's one-pass quantizer
SYMBOLS = {
    "int4_matmul_pallas": (("int4_mm_stream",), ("int4_mm_kernel",)),
    "fused_mlp_int4": (("mlp4_gate_up", "mlp4_down", "mlp4_sum_tiles"), ("mlp4_tiles",)),
    "fused_mlp_int8": (("mlp8_gate_up", "mlp8_down", "mlp8_sum_tiles"), ("mlp8_tiles",)),
    "decode_attention_q_chunk": (("chunk_walk",), ("decode_walk",)),
    "decode_attention_q": (("chunk_walk",), ("decode_walk",)),
    "decode_attention": (("flat_walk",), ("decode_walk",)),
    "decode_attention fp32": (("decode_walk",), ("flat_walk",)),
    "w8a8_gemm": (("quantize_rows", "transpose_w", "w8a8_wgmma"), ("w8a8_kernel",)),
    "w8a8_gemm K % 16 != 0": (("w8a8_kernel",), ("quantize_rows", "transpose_w", "w8a8_wgmma")),
    "fused_layer_tail": (("wgt::fused_tail",), ()),
    "quantize_tokens": (("quantize_rows",), ()),
}


def log_symbols(name, fn):
    """One call of fn under the profiler: fails unless it launched every
    kernel of the name's engine and none of the engine it left."""
    want, gone = SYMBOLS[name]
    ours = traced_kernels(name, fn)
    missing = [w for w in want if not any(w in n for n in ours)]
    old = [o for o in gone if any(o in n for n in ours)]
    log(f"  {name} launches {'; '.join(ours)}")
    if missing or old:
        raise AssertionError(f"{name}: kernels {ours}, missing {missing}, old engine {old}")


def k3_case(dev, dtype, b, h, gh, gw, d, gen, strided=False):
    """strided: q, k, v as head views of one [B, N, 3 H D] projection, as the
    encoder passes them (row stride 3 H D; at D = 20 the rows start 8-byte
    aligned and the kernel takes its 2-byte loads)."""
    n = gh * gw
    if strided:
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=dev).to(dtype)
        q, k, v = (x.reshape(b, n, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
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
    # K1 at the serving admit (one row of prompt_len 1024) and the training
    # forward (2 rows of 767 spliced tokens, the second with 60 pad keys)
    check_kernel("flash_attention", k1_case(dev, bf16, 1, 32, 1024, 128, [700], gen), bf16, 50,
                 3, "serving admit")
    check_kernel("flash_attention", k1_case(dev, bf16, 2, 32, 767, 128, [767, 707], gen), bf16,
                 50, 3, "7B training")
    torch.cuda.empty_cache()
    f32 = torch.float32
    ragged = lambda name, case, dtype=f32, label="ragged": check_kernel(name, case, dtype, 0, 1,
                                                                        label)
    ragged("flash_attention", k1_case(dev, f32, 2, 3, 70, 128, [70, 59], gen))
    ragged("flash_attention", k1_case(dev, f32, 2, 2, 37, 20, [37, 30], gen))
    # K1's bf16 route at ragged tiles: N = 70, 37 and 130, D = 128, 20 (2-byte
    # loads, a padded head dim) and 80
    for n, d, lengths in ((70, 128, [70, 59]), (37, 20, [37, 30]), (130, 80, [130, 101])):
        ragged("flash_attention", k1_case(dev, bf16, 2, 3, n, d, lengths, gen), bf16,
               f"ragged N={n} D={d}")
    k1_masked_rows(dev, gen)
    for n, d in ((447, 128), (130, 80)):
        k1_split_check(dev, n, d, gen)
    ragged("sam_window_attention_packed", k2_case(dev, f32, 3, 2, 80, 14, gen))
    ragged("sam_window_attention_packed", k2_case(dev, f32, 5, 3, 20, 3, gen))
    # K2's bf16 route at the edges of its tiles: T = 49 and 9 (one ragged key
    # and query tile), D = 20 (2-byte loads, a padded head dim) and 64, odd
    # windows (the rel rows by plain loads)
    for bw, h, d, ws in ((5, 3, 20, 7), (5, 3, 20, 3), (4, 2, 64, 7), (3, 2, 80, 14)):
        ragged("sam_window_attention_packed", k2_case(dev, bf16, bw, h, d, ws, gen), bf16,
               f"ragged ws={ws} D={d}")
    ragged("sam_flash_attention", k3_case(dev, f32, 2, 2, 5, 7, 20, gen))
    ragged("sam_flash_attention", k3_case(dev, f32, 1, 2, 16, 16, 80, gen))
    # K3's bf16 route at the edges of its tiles: head views at D = 20
    # (unaligned rows), key tiles that cut grid rows (gw = 40), a 16 x 16 grid;
    # whole grid rows per key tile off the production instantiation (gw = 64
    # at D = 40, gw = 128), contiguous and as head views
    for (gh, gw, d), strided in (((5, 7, 20), True), ((12, 40, 64), False), ((16, 16, 80), False),
                                 ((16, 64, 40), False), ((16, 64, 40), True),
                                 ((8, 128, 64), False), ((8, 128, 64), True)):
        ragged("sam_flash_attention", k3_case(dev, bf16, 2, 2, gh, gw, d, gen, strided), bf16,
               f"ragged {gh}x{gw} D={d}{' head views' if strided else ''}")
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


def k4_case(dev, dtype, b, h, n_kv, d, l, valid, pack4, gen, walk=False):
    """walk: run K4 on its walk route (fa.decode_attention_q_walk)."""
    kq, ks, kd, vq, vs, vd = flat_cache(dev, gen, b, l, n_kv, d, pack4)
    q = torch.randn(b, h * d, generator=gen, device=dev).to(dtype)
    mask = torch.arange(l, device=dev)[None].expand(b, l) < valid
    mask = mask.contiguous()
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, valid_len=valid)
    fn = fa.decode_attention_q_walk if walk else fa.decode_attention_q
    run = lambda: fn(q, kq, ks, vq, vs, mask, **kw)
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


def k4_against_walk(dev, label, dtype, b, h, n_kv, d, l, valid, pack4, qdot8, gen):
    """K4's wrapper (the chunk engine) against the walk route
    (fa.decode_attention_q_walk) on the same inputs, bit for bit: the two
    engines keep the same rounding points in the same order. The key mask
    has holes below valid_len (a serving pool's), key 0 valid."""
    kq, ks, _, vq, vs, _ = flat_cache(dev, gen, b, l, n_kv, d, pack4)
    q = torch.randn(b, h * d, generator=gen, device=dev).to(dtype)
    pos = torch.arange(l, device=dev)[None]
    mask = (torch.rand(b, l, generator=gen, device=dev) < 0.9) & (pos < valid)
    mask[:, 0] = True
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, valid_len=valid, qdot_int8=qdot8)
    got = fa.decode_attention_q(q, kq, ks, vq, vs, mask, **kw)
    want = fa.decode_attention_q_walk(q, kq, ks, vq, vs, mask, **kw)
    same = torch.equal(got, want)
    log(f"  decode_attention_q {label} {str(dtype)[6:]} {'int8' if qdot8 else 'bf16'} scores: "
        f"the chunk engine equals the walk bit for bit: {same}")
    if not same:
        raise AssertionError(f"decode_attention_q {label}: the chunk engine parts from the walk "
                             f"(max_abs {float((got.float() - want.float()).abs().max()):.3e})")


def host_us(fn, n=200):
    """Host microseconds per call of fn: the host time of n calls with no
    synchronisation inside (the wrapper's checks and its C entry's launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def k4_host_us(dev, gen, n=200):
    """K4's wrapper at the 7B step: host microseconds per call beside the
    wall per call with the card's work included (CUDA events)."""
    run = k4_case(dev, torch.bfloat16, 2, 32, 32, 128, 512, 480, True, gen)[0]
    log(f"  decode_attention_q 7B int4_flat: host_us per call {host_us(run, n):.1f} (enqueue of "
        f"{n}); ms per call with the card's work {cuda_ms(run, n):.4f}")


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


def rows_check(label, fn, hold=True):
    """fn(rows) (rows: a slice of a 4-row batch) on the 4 rows against each
    row alone and rows 1-2 together, and twice on the same rows, bit for
    bit. hold: fail unless every comparison holds (a kernel whose sums run
    in an order fixed by the shapes: the serving check's alone_in_pool rests
    on it); else the result is only logged."""
    out = fn(slice(0, 4))
    same = [torch.equal(out[r], fn(slice(r, r + 1))[0]) for r in range(4)]
    pair = torch.equal(out[1:3], fn(slice(1, 3)))
    again = torch.equal(out, fn(slice(0, 4)))
    ok = all(same) and pair and again
    log(f"  {label}: each of 4 rows equals the row alone {same}, rows 1-2 together {pair}; "
        f"a second call gives the same bits {again}" + ("" if hold else " (logged, not held)"))
    if hold and not ok:
        raise AssertionError(f"{label}: the rows depend on the batch, or the bits on the run")


def quant_rows_checks(dev, gen):
    """Rows checks at the serving pool's 4 rows: K5 on the 7B qkv4, K6 on the
    7B int4 MLP and K7 on the 1B W8A8 MLP, held; K4 on the 7B int4_flat step
    (a mask per row, with holes) and the decode step's RMSNorm (a PyTorch
    row reduction), logged: which part of the 7B int4x decode step, if any,
    rounds otherwise at 1 row than at 4."""
    bf16 = torch.bfloat16
    w = int4.quantize_weight4(torch.randn(4096, 12288, generator=gen, device=dev) * 0.02)
    x = torch.randn(4, 4096, generator=gen, device=dev).to(bf16)
    rows_check("int4_matmul_pallas 7B qkv4",
               lambda r: int4.int4_matmul_pallas(x[r], w["w_p4"], w["w_scale"]))
    del w
    p = int4_mlp(dev, gen, 4096, 11008, "silu")
    x = torch.randn(4, 1, 4096, generator=gen, device=dev).to(bf16)
    rows_check("fused_mlp_int4 7B mlp", lambda r: int4.fused_mlp_int4(p, x[r], "silu"))
    p = {n: quant.convert_proj({"w": torch.randn(*shape, generator=gen, device=dev) * 0.02}, True)
         for n, shape in (("gate", (2048, 5504)), ("up", (2048, 5504)), ("down", (5504, 2048)))}
    x = torch.randn(4, 1, 2048, generator=gen, device=dev).to(bf16)
    rows_check("fused_mlp_int8 1B mlp", lambda r: int4.fused_mlp_int8(p, x[r], "silu"))
    same = torch.equal(int4.fused_mlp_int8(p, x, "silu"),
                       int4.fused_mlp_int8_reference(p, x, "silu"))
    log(f"  fused_mlp_int8 1B mlp, 4 rows: equals its plain version bit for bit: {same} "
        f"(logged, not held: the plain version's silu and products are PyTorch's)")
    del p
    kq, ks, _, vq, vs, _ = flat_cache(dev, gen, 4, 512, 32, 128, True)
    q = torch.randn(4, 32 * 128, generator=gen, device=dev).to(bf16)
    pos = torch.arange(512, device=dev)[None]
    lengths = torch.tensor([[480], [471], [455], [402]], device=dev)
    mask = (torch.rand(4, 512, generator=gen, device=dev) < 0.9) & (pos < lengths)
    mask[:, 0] = True
    kw = dict(n_kv=32, head_dim=128, pack4=True, layer=0, valid_len=480)
    rows_check("decode_attention_q 7B int4_flat (masks per row)",
               lambda r: fa.decode_attention_q(q[r], kq[:, r], ks[:, r], vq[:, r], vs[:, r],
                                               mask[r], **kw), hold=False)
    norm = {"scale": (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(bf16)}
    x = torch.randn(4, 1, 4096, generator=gen, device=dev).to(bf16)
    rows_check("rms_norm 7B (PyTorch's mean over a row)",
               lambda r: nn.rms_norm(norm, x[r], eps=1e-5), hold=False)


def phase_quant_kernels(dev, seed):
    log("== phase 2b: K4-K7 against their plain versions; K5's, K6's, K7's (held), K4's and "
        "RMSNorm's (logged) rows against each row alone")
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
            "int4_matmul_pallas", k5_case(dev, bf16, 2, 4096, 12288, gen), bf16, 200,
            "7B qkv4"),
        "fused_mlp_int4": check(
            "fused_mlp_int4", mlp_case(dev, bf16, "int4", 2, 4096, 11008, gen), bf16, 50,
            "7B mlp"),
        "fused_mlp_int8": check(
            "fused_mlp_int8", mlp_case(dev, bf16, "int8", 2, 2048, 5504, gen), bf16, 200,
            "1B mlp"),
    }
    # K5 and K7 at the other decode rows: 1 (K5 only), the serving pool's 4
    # and the speculative chunk's 18 (2 rows x SPEC_K + 1 tokens); K7 at a
    # 7B-width W8A8 MLP, K5 at the 13B qkv4; K6 at the 7B server's pool
    for m in (1, 4, SPEC_K * 2 + 2):
        check("int4_matmul_pallas", k5_case(dev, bf16, m, 4096, 12288, gen), bf16, 100,
              f"7B qkv4, {m} rows")
    for m in (4, SPEC_K * 2 + 2):
        check("fused_mlp_int8", mlp_case(dev, bf16, "int8", m, 2048, 5504, gen), bf16, 100,
              f"1B mlp, {m} rows")
    check("fused_mlp_int8", mlp_case(dev, bf16, "int8", 2, 4096, 11008, gen), bf16, 50,
          "7B-width W8A8 mlp")
    check("int4_matmul_pallas", k5_case(dev, bf16, 2, 5120, 15360, gen), bf16, 50, "13B qkv4")
    check("fused_mlp_int4", mlp_case(dev, bf16, "int4", 4, 4096, 11008, gen), bf16, 50,
          "7B mlp, 4 rows (the serving pool)")
    torch.cuda.empty_cache()
    quant_rows_checks(dev, gen)
    tie_pick_check(dev, gen)
    check("decode_attention_q", k4_case(dev, bf16, 2, 16, 16, 128, 512, 480, False, gen),
          bf16, 200, "1B int8_flat")
    k4_host_us(dev, gen)
    # K4's chunk engine against the walk, bit for bit: the 7B step at the
    # request's 2 rows and the server's 4, the 1B step, ragged GQA (odd n_kv
    # int4, n_rep 8 int8), with int8 and with bf16 scores, masks with holes
    for b, h, n_kv, d, l, valid, pack4, label in (
            (2, 32, 32, 128, 512, 480, True, "7B int4_flat"),
            (4, 32, 32, 128, 512, 480, True, "7B int4_flat, 4 rows"),
            (2, 16, 16, 128, 512, 480, False, "1B int8_flat"),
            (3, 6, 3, 40, 96, 70, True, "ragged GQA odd n_kv int4"),
            (2, 16, 2, 24, 64, 64, False, "ragged n_rep 8 int8")):
        for qdot8 in (True, False):
            for dtype in ((bf16, f32) if d < 128 else (bf16,)):
                k4_against_walk(dev, label, dtype, b, h, n_kv, d, l, valid, pack4, qdot8, gen)
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


def k11_case(dev, dtype, b, h, n_kv, d, l, valid, gen, walk=False):
    """walk: run K11 on its walk route (fa.decode_attention_walk)."""
    k, v = (torch.randn(1, b, l, n_kv * d, generator=gen, device=dev).to(dtype) for _ in range(2))
    q = torch.randn(b, h * d, generator=gen, device=dev).to(dtype)
    mask = (torch.arange(l, device=dev)[None] < torch.tensor(valid, device=dev)[:, None])
    fn = fa.decode_attention_walk if walk else fa.decode_attention
    run = lambda: fn(q, k, v, mask, n_kv=n_kv)
    plain = lambda: fa.decode_attention_reference(q, k, v, mask, n_kv=n_kv)
    rep = h // n_kv
    heads = lambda x: x[0].view(b, l, n_kv, d).transpose(1, 2).repeat_interleave(rep, 1)
    kh, vh = heads(k), heads(v)
    library = lambda: F.scaled_dot_product_attention(q.view(b, h, 1, d), kh, vh,
                                                     attn_mask=mask[:, None, None])
    # the k and v rows of the valid keys, the mask, q and the output
    nb = 2 * sum(valid) * n_kv * d * k.element_size() + mask.numel() + 2 * nbytes(q)
    return run, plain, library, (nb, 4.0 * h * d * sum(valid), torch.bfloat16)


def k11_against_walk(dev, label, b, h, n_kv, d, l, valid, gen, holes=False):
    """K11's wrapper (bf16: decode_flat.cuh) against its walk route
    (fa.decode_attention_walk) on the same bf16 inputs, bit for bit: the
    engine repeats the walk's expressions in the same order. holes: keys
    missing below valid (a serving pool's mask), key 0 valid."""
    k, v = (torch.randn(1, b, l, n_kv * d, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn(b, h * d, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(l, device=dev)[None]
    mask = pos < torch.tensor(valid, device=dev)[:, None]
    if holes:
        mask &= torch.rand(b, l, generator=gen, device=dev) < 0.9
        mask[:, 0] = True
    got = fa.decode_attention(q, k, v, mask, n_kv=n_kv)
    want = fa.decode_attention_walk(q, k, v, mask, n_kv=n_kv)
    same = torch.equal(got, want)
    log(f"  decode_attention {label}: the flat engine equals the walk bit for bit: {same}")
    if not same:
        raise AssertionError(f"decode_attention {label}: the flat engine parts from the walk "
                             f"(max_abs {float((got.float() - want.float()).abs().max()):.3e})")


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
    # K11's bf16 engine against its walk, bit for bit: the dense 7B step at
    # the request's 2 rows and 4, 13B and 1B steps, ragged GQA (D = 40, 16-byte
    # copies; D = 20, element-wise staging; n_rep 32, two query groups),
    # masks with holes
    for b, h, n_kv, d, l, valid, holes, label in (
            (2, 32, 32, 128, 512, [480, 480], False, "7B"),
            (4, 32, 32, 128, 512, [480, 300, 257, 1], True, "7B 4 rows, holes"),
            (2, 40, 40, 128, 512, [480, 200], False, "13B"),
            (2, 16, 16, 128, 512, [480, 480], True, "1B, holes"),
            (2, 6, 3, 40, 96, [90, 17], False, "ragged GQA D=40"),
            (3, 8, 2, 20, 64, [64, 30, 5], True, "ragged GQA D=20"),
            (2, 32, 1, 64, 768, [700, 260], True, "n_rep 32, D=64")):
        k11_against_walk(dev, label, b, h, n_kv, d, l, valid, gen, holes)
    check_kernel("decode_attention", k11_case(dev, bf16, 2, 6, 3, 40, 96, [90, 17], gen), bf16, 0,
                 1, "ragged GQA", relative=True)
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


def k3b_case(dev, dtype, b, h, gh, gw, d, gen, strided=False):
    """strided: q, k, v as head views of one projection (k3_case's)."""
    n = gh * gw
    if strided:
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=dev).to(dtype)
        q, k, v = (x.reshape(b, n, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
    g = torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype)
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
    # K1b's bf16 route (the pair layout) at ragged tiles: N = 70, 37 and 130,
    # D = 128, 80, 64 and 20; row 1's first 5 keys invalid, so its queries
    # 0-4 see no key (fully masked rows: dq exactly 0)
    for n, d, lengths in ((70, 128, [70, 59]), (37, 80, [37, 30]), (130, 64, [130, 101]),
                          (37, 20, [37, 33])):
        case = k1b_case(dev, bf16, 2, 3, n, d, lengths, gen, 5)
        check_backward("flash_attention_bwd", case, bf16, 0, 1,
                       f"ragged N={n} D={d}, fully masked rows")
        dq = case[0]()[0]
        zero = not bool(dq[1, :, :5].any())
        log(f"  flash_attention_bwd ragged N={n} D={d} bf16: the fully masked rows' dq is exactly "
            f"0: {zero} -> {'ok' if zero else 'FAIL'}")
        if not zero:
            raise AssertionError("flash_attention_bwd: a fully masked row got a gradient")
    ragged("sam_window_attention_packed_bwd", k2b_case(dev, f32, 3, 2, 80, 14, gen), "ragged")
    ragged("sam_window_attention_packed_bwd", k2b_case(dev, f32, 5, 3, 20, 3, gen), "ragged")
    # K2b's bf16 route at the edges of its tiles: T = 9, 25, 49 and 196 (one
    # ragged tile each way; key tiles that cut window rows at ws = 5, 7, 14),
    # D = 16 and 20 (2-byte loads; 20 a padded head dim), odd BW * H; a
    # window of 17 (T = 289) takes the general rel-gradient path
    for bw, h, d, ws in ((5, 3, 16, 3), (3, 3, 20, 5), (5, 3, 80, 7), (3, 1, 20, 7),
                         (3, 3, 80, 14), (2, 2, 16, 17)):
        check_backward("sam_window_attention_packed_bwd", k2b_case(dev, bf16, bw, h, d, ws, gen),
                       bf16, 0, 1, f"ragged ws={ws} D={d} BW*H={bw * h}")
    ragged("sam_flash_attention_bwd", k3b_case(dev, f32, 2, 2, 5, 7, 20, gen), "ragged")
    ragged("sam_flash_attention_bwd", k3b_case(dev, f32, 1, 2, 16, 16, 80, gen), "ragged")
    for (gh, gw, d), strided in (((5, 7, 20), False), ((12, 40, 64), False), ((16, 16, 80), False),
                                 ((16, 64, 40), False), ((16, 64, 40), True),
                                 ((8, 128, 64), False), ((8, 128, 64), True)):
        check_backward("sam_flash_attention_bwd",
                       k3b_case(dev, bf16, 2, 2, gh, gw, d, gen, strided), bf16, 0, 1,
                       f"ragged {gh}x{gw} D={d}{' head views' if strided else ''}")
    bf16_twice("flash_attention_bwd", "7B training",
               k1b_case(dev, bf16, 2, 32, 767, 128, [767, 707], gen)[0])
    for n, d in ((767, 128), (130, 64)):
        k1b_split_check(dev, n, d, gen)
    bf16_twice("sam_window_attention_packed_bwd", "ViT-H windows",
               k2b_case(dev, bf16, 50, 16, 80, 14, gen)[0])
    window_delta_check(dev, gen)
    for ws, d in ((14, 80), (7, 20)):
        k2b_split_check(dev, ws, d, gen)
    bf16_twice("sam_flash_attention_bwd", "ViT-H global",
               k3b_case(dev, bf16, 2, 16, 64, 64, 80, gen)[0])
    for gh, gw, d in ((64, 64, 80), (12, 40, 64)):
        k3b_split_check(dev, gh, gw, d, gen)
    return results


def bf16_twice(name, label, run):
    """A backward twice on the same bf16 inputs: bit-identical gradients (one
    owner per element, a fixed order, no atomics)."""
    first = run()
    second = run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"  {name} {label} bf16 twice: bit-identical -> {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name} gave different gradients on a second run")


def window_delta_check(dev, gen):
    """K2b's and K10b's delta kernel (fa._window_delta) against the plain
    fa._delta at ViT-H's windows, both dtypes: each row within 1e-5 of the
    sum of its terms' magnitudes (fp32 sums of the same exact products in
    another order); both timed."""
    for dtype in (torch.bfloat16, torch.float32):
        g, out = (torch.randn(50, 196, 16, 80, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        got, want = fa._window_delta("delta", g, out), fa._delta(g, out)
        limit = 1e-5 * fa._delta(g.abs(), out.abs())
        worst = float(((got - want).abs() / limit).max())
        ms = cuda_ms(lambda: fa._window_delta("delta", g, out), 20)
        plain = cuda_ms(lambda: fa._delta(g, out), 20)
        log(f"  window delta kernel {str(dtype)[6:]} [50, 196, 16, 80]: largest error over its "
            f"limit {worst:.3f} (at most 1), {ms:.4f} ms against the plain _delta's {plain:.4f}"
            f" -> {'ok' if worst <= 1 else 'FAIL'}")
        if not worst <= 1:
            raise AssertionError(f"the window delta kernel disagrees with _delta in {dtype}")


def split_products(p, ds, q, k, g, scale):
    """dq, dk and dv of a backward from its own fp32 p and ds ([.., N, NK])
    and its bf16 q, k and g, every product in float64: once exactly, once
    with p and ds rounded to bf16 alone first (FlashAttention's scheme,
    which the kernels' hi + lo split replaces)."""
    out = []
    for pp, dd in ((p, ds), (p.to(q.dtype), ds.to(q.dtype))):
        pp, dd = pp.double(), dd.double()
        out.append((torch.einsum("bhqk,bhkd->bhqd", dd, k.double()) * scale,
                    torch.einsum("bhqk,bhqd->bhkd", dd, q.double()) * scale,
                    torch.einsum("bhqk,bhqd->bhkd", pp, g.double())))
    return out


def hold_split(name, label, got, exact, single):
    """The kernel's dq, dk and dv against the float64 products, each rounded
    to bf16 as the kernel writes it, beside p and ds rounded to bf16 alone:
    the hi + lo split keeps about 16 bits of p and ds, so the kernel's mean
    error must stay SPLIT_GAIN times under the single-bf16 scheme's
    (rounding p and ds to bf16 alone fails this)."""
    ok = True
    for grad, a, e, si in zip(("dq", "dk", "dv"), got, exact, single):
        e = e.to(torch.bfloat16).float()
        err_kernel = float((a.float() - e).abs().mean())
        err_single = float((si.to(torch.bfloat16).float() - e).abs().mean())
        good = err_kernel * SPLIT_GAIN <= err_single
        ok &= good
        log(f"  {name} split products {label} {grad}: mean_abs against float64 products "
            f"{err_kernel:.3e}, p and ds in bf16 alone {err_single:.3e} (ratio "
            f"{err_single / err_kernel if err_kernel else math.inf:.1f}, at least {SPLIT_GAIN}) -> "
            f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the split products are not closer than bf16 alone")


def _qk(q, k, scale=None):
    """q . k^T summed in float64, rounded to fp32; with scale, q * scale
    rounded to q's dtype first (SAM's logits)."""
    if scale is not None:
        q = q * torch.tensor(scale, dtype=q.dtype)
    return torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()).float()


def _p_ds(s, lse, g, v, out):
    """p = exp(s - lse) and ds = p (g . v^T - delta) in fp32, dp from the
    bf16 operands."""
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g.double(), v.double()).float()
    return p, p * (dp - fa._delta(g, out)[..., None])


def k1b_split_check(dev, n, d, gen):
    """hold_split for K1b at a causal shape with padded keys (2 rows, the
    second without its last n // 10 keys); s = scale (q . k), p exactly 0
    where masked."""
    q, k, v, g = (torch.randn(2, 2, n, d, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    kv = torch.arange(n, device=dev)[None] < torch.tensor([n, n - n // 10], device=dev)[:, None]
    out, lse = fa.flash_attention(q, k, v, True, kv, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, True, kv, out, lse, g)
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(n, device=dev)
    mask = kv[:, None, None, :] & (pos[None, :] <= pos[:, None])[None, None]
    p, ds = _p_ds((_qk(q, k) * scale).masked_fill(~mask, -math.inf), lse, g, v, out)
    hold_split("flash_attention_bwd", f"N={n} D={d}", got,
               *split_products(p, ds, q, k, g, scale))


def k2b_split_check(dev, ws, d, gen):
    """hold_split for K2b at 5 windows of 3 heads (T = ws^2; the kernel's
    gradients taken out of the packed dqkv); s = (q * scale)_bf16 . k +
    (rel_h + rel_w), as the forward forms it."""
    bw, h, t = 5, 3, ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=gen, device=dev).to(torch.bfloat16)
    rel = torch.randn(bw, t, 2 * h * ws, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(bw, t, h * d, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    dqkv = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, out, lse, g)[0]
    got = [fa._win_heads(x, h, d) for x in dqkv.split(h * d, dim=-1)]
    q, k, v, rel_h, rel_w = fa._win_split_heads(qkv, rel, h, d, ws)
    gh, oh = fa._win_heads(g, h, d), fa._win_heads(out, h, d)
    key = torch.arange(t, device=dev)
    s = _qk(q, k, 1.0 / math.sqrt(d)) + (rel_h.float()[..., key // ws]
                                          + rel_w.float()[..., key % ws])
    p, ds = _p_ds(s, lse.transpose(1, 2), gh, v, oh)
    hold_split("sam_window_attention_packed_bwd", f"ws={ws} D={d}", got,
               *split_products(p, ds, q, k, gh, 1.0 / math.sqrt(d)))


def k3b_split_check(dev, gh, gw, d, gen):
    """hold_split for K3b on one image of 2 heads; s = (q * scale)_bf16 . k,
    then (s + rel_w) + rel_h."""
    n = gh * gw
    q, k, v, g = (torch.randn(1, 2, n, d, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    rel_h = torch.randn(1, 2, n, gh, generator=gen, device=dev).to(torch.bfloat16)
    rel_w = torch.randn(1, 2, n, gw, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    got = fa.sam_flash_attention_bwd(q, k, v, rel_h, rel_w, (gh, gw), out, lse, g)
    key = torch.arange(n, device=dev)
    s = _qk(q, k, 1.0 / math.sqrt(d))
    s = (s + rel_w.float()[..., key % gw]) + rel_h.float()[..., key // gw]
    p, ds = _p_ds(s, lse, g, v, out)
    hold_split("sam_flash_attention_bwd", f"{gh}x{gw} D={d}", got,
               *split_products(p, ds, q, k, g, 1.0 / math.sqrt(d)))


# ---------------------------------------------------------------------------
# phase 2f: K10 and K10b, windowed attention over the split-head layout
# ---------------------------------------------------------------------------

def _merge(x):
    """[BW, H, T, w] -> [BW, T, H*w] lanes (K2's packed layout)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)


def k10_inputs(dev, dtype, rel_dtype, bw, h, d, ws, gen):
    t = ws * ws
    q, k, v, g = (torch.randn(bw, h, t, d, generator=gen, device=dev).to(dtype)
                  for _ in range(4))
    rel_h, rel_w = (torch.randn(bw, h, t, ws, generator=gen, device=dev).to(rel_dtype)
                    for _ in range(2))
    return q, k, v, rel_h, rel_w, g


def _bias(rel_h, rel_w, ws, dtype):
    """The expanded [BW, H, T, T] rel-pos bias, built once for the library call."""
    key = torch.arange(ws * ws, device=rel_h.device)
    return (rel_h.float()[..., key // ws] + rel_w.float()[..., key % ws]).to(dtype)


def k10_case(inputs, ws):
    q, k, v, rel_h, rel_w, _ = inputs
    bw, h, t, d = q.shape
    run = lambda: fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    plain = lambda: fa.sam_window_attention_reference(q, k, v, rel_h, rel_w, ws)
    bias = _bias(rel_h, rel_w, ws, q.dtype)
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    out_bytes = nbytes(q) + bw * h * t * 4
    return run, plain, library, (nbytes(q, k, v, rel_h, rel_w) + out_bytes,
                                 4.0 * d * t * t * bw * h, q.dtype)


def k10b_case(inputs, ws):
    q, k, v, rel_h, rel_w, g = inputs
    bw, h, t, d = q.shape
    out, lse = fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    args = (q, k, v, rel_h, rel_w, ws, out, lse, g)
    bias = _bias(rel_h, rel_w, ws, q.dtype)
    library = _library_bwd(lambda a, b, c: F.scaled_dot_product_attention(a, b, c,
                                                                          attn_mask=bias),
                           (q, k, v), g)
    nb = nbytes(q, k, v, rel_h, rel_w, out, lse, g) + nbytes(q, k, v, rel_h, rel_w)
    return (lambda: fa.sam_window_attention_bwd(*args),
            lambda: fa.sam_window_attention_bwd_reference(*args), library,
            (nb, 10.0 * d * t * t * bw * h, q.dtype))


def k10_against_k2(inputs, ws, label):
    """K10 and K10b against K2 and K2b on the same values repacked into the
    packed layout: one engine, the same logits, so equal bit for bit (held
    to the bf16 bounds and the equality reported otherwise)."""
    q, k, v, rel_h, rel_w, g = inputs
    h, d = q.shape[1], q.shape[3]
    out, lse = fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    qkv, rel = torch.cat([_merge(x) for x in (q, k, v)], -1), torch.cat([_merge(rel_h),
                                                                         _merge(rel_w)], -1)
    pout, plse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    grads = fa.sam_window_attention_bwd(q, k, v, rel_h, rel_w, ws, out, lse, g)
    pgrads = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, pout, plse, _merge(g))
    got = (_merge(out), lse, torch.cat([_merge(x) for x in grads[:3]], -1),
           torch.cat([_merge(x) for x in grads[3:]], -1))
    want = (pout, plse.transpose(1, 2), *pgrads)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    worst = max(errors(a, b)[0] / max(1.0, float(b.float().abs().max()))
                for a, b in zip(got, want))
    log(f"  K10/K10b against K2/K2b on repacked values ({label}): out, lse, dqkv and drel "
        f"bit for bit: {same} (largest difference relative to its output {worst:.3e})")
    if not (same or worst <= BF16_MAX_ABS):
        raise AssertionError(f"K10 disagrees with K2 on repacked values ({label})")
    return same


def phase_window_split_kernels(dev, seed):
    log("== phase 2f: K10 and K10b (split-layout window attention) against their plain "
        "versions and against K2/K2b")
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    bf16, f32 = torch.bfloat16, torch.float32
    # the ViT-H windowed block for two 1024^2 images: 2 x 25 windows of 14 x 14
    vit = k10_inputs(dev, bf16, bf16, 50, 16, 80, 14, gen)
    results = {
        "sam_window_attention": check_kernel(
            "sam_window_attention", k10_case(vit, 14), bf16, 20, 3, "ViT-H windows"),
        "sam_window_attention_bwd": check_backward(
            "sam_window_attention_bwd", k10b_case(vit, 14), bf16, 10, 3, "ViT-H windows"),
    }
    same = k10_against_k2(vit, 14, "ViT-H windows, bf16")
    del vit
    torch.cuda.empty_cache()
    # ragged fp32 shapes (BW*H odd, D = 16 and 80, ws = 3 and 5), the bf16
    # route's at ws = 3 and 7 (D = 16 and 20), then a bf16 q with fp32 rel
    # tables (which the JAX kernel takes too)
    for dtype, rdt, bw, h, d, ws in ((f32, f32, 3, 1, 16, 3), (f32, f32, 5, 3, 80, 5),
                                     (bf16, bf16, 5, 3, 16, 3), (bf16, bf16, 3, 1, 20, 7),
                                     (bf16, f32, 3, 3, 80, 5)):
        label = f"ragged ws={ws} D={d} BW*H={bw * h}" + (", fp32 rel" if rdt != dtype else "")
        inputs = k10_inputs(dev, dtype, rdt, bw, h, d, ws, gen)
        check_kernel("sam_window_attention", k10_case(inputs, ws), dtype, 0, 1, label)
        check_backward("sam_window_attention_bwd", k10b_case(inputs, ws), dtype, 0, 1, label)
        if rdt == dtype:
            same &= k10_against_k2(inputs, ws, label)
    log(f"  K10/K10b equal K2/K2b bit for bit in every case: {same}")
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


def k12_case(dev, gen, b, h, d, l, valid, pack4, i_dim, act, dtype):
    """K12 at one layer of a decode step (MHA, h heads of d, a flat
    quantized cache of l slots, `valid` of them valid), random inputs in
    the int4x format: (run, plain, unfused, cost, inputs); run returns K12's
    y, whose `_base` is the launch's scratch (fused_layer_tail_plan's rows);
    unfused is the sequence K4, nn.linear's a8 o-proj, rms_norm, K6 (no one
    PyTorch call computes the tail); inputs holds q, the cache, the mask,
    the MLP and fused_layer_tail's arguments (args, kw)."""
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
    args = (x, q8, qs, *cache, mask, o, pn, mlp)
    run = lambda: fused_layer.fused_layer_tail(*args, **kw)
    plain = lambda: fused_layer.fused_layer_tail_reference(*args, **kw)

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
    inputs = dict(q=q, cache=cache, mask=mask, mlp=mlp, args=args, kw=kw)
    return run, plain, unfused, (nb, ops, torch.bfloat16), inputs


def check_k12(dev, gen, label, b, h, d, l, valid, pack4, i_dim, act, dtype, iters):
    """K12 against its plain version at one layer of a decode step
    (k12_case): the output within the bf16 bounds of its largest magnitude,
    the attention rows (row 0 of the wrapper's scratch, of which the result
    is row 2) within QUANT_FP32_REL of K4's plain version on the same q,
    their o-proj codes within one and at most K12_CODE_FLIPS of them moved,
    its MLP partials K6's on its own normed rows (scratch row hn) bit for
    bit, and its launch (fused_layer_tail_info: blocks, blocks an SM, shared
    memory, rows per pass, hn held) fused_layer_tail_plan's.
    Then (iters > 0) kernel, plain and the unfused sequence's ms
    (library_ms is None), and the bound."""
    run, plain, unfused, cost, inp = k12_case(dev, gen, b, h, d, l, valid, pack4, i_dim, act,
                                              dtype)
    q, cache, mask = inp["q"], inp["cache"], inp["mask"]
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
    info = fused_layer.fused_layer_tail_info(b, h, d, l, i_dim, pack4, dtype, dtype, dev)
    plan = fused_layer.fused_layer_tail_plan(b, h, d, l, i_dim, pack4, sms=info["sms"])
    rows = plan["scratch"]
    k6 = int4.fused_mlp_int4_parts(inp["mlp"], y._base[rows["hn"]], act)
    same_k6 = torch.equal(y._base[rows["parts"]:rows["rows"]], k6)
    keys = ("blocks", "blocks_per_sm", "smem", "rows_per_pass", "hn_held")
    same_plan = all(info[k] == plan[k] for k in keys)
    ok = (max_err <= BF16_MAX_ABS * scale and mean_err <= BF16_MEAN_ABS * scale
          and att_err <= QUANT_FP32_REL and float(moved.max()) <= 1
          and float((moved > 0).float().mean()) <= K12_CODE_FLIPS and same_k6 and same_plan)
    log(f"  fused_layer_tail {label} {str(dtype)[6:]} check max_abs={max_err:.3e} "
        f"mean_abs={mean_err:.3e} (output scale {scale:.3g}); attention rows max_rel="
        f"{att_err:.3e}; o-proj codes moved {int((moved > 0).sum())} of {moved.numel()} "
        f"(max {int(moved.max())}); MLP partials equal K6's on its hn: {same_k6}; launch "
        f"{info['blocks']} blocks ({info['blocks_per_sm']} an SM), {info['smem']} bytes of "
        f"shared memory, hn held there: {bool(info['hn_held'])}, the plan's: {same_plan} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_layer_tail disagrees with its plain version or its "
                             f"launch with its plan ({label})")
    if iters == 0:
        return None
    res = measure(f"fused_layer_tail {label}", run, plain, None, cost, iters, 4, plain_ms)
    res["unfused_ms"] = cuda_ms(unfused, iters)
    log(f"  fused_layer_tail {label}: the unfused sequence on the card (K4, a8 o-proj, "
        f"rms_norm, K6) unfused_ms={res['unfused_ms']:.4f}")
    return dict(max_abs_err=max_err, **res)


def k13b_case(dev, gen, m, k, n, bias, act, dtype):
    """K13b at one product [m, k] x [k, n] (random x and weights in the W8A8
    format): (run, plain, library, cost, x, w, b); library is torch._int_mm
    on the same codes (the int32 product only, no quantize, scales, bias or
    activation)."""
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = quant.convert_proj({"w": torch.randn(k, n, generator=gen, device=dev) * 0.02}, True)
    b = torch.randn(n, generator=gen, device=dev) * 0.1 if bias else None
    run = lambda: int8_gemm.w8a8_gemm(x, w["w_q"], w["w_scale"], b, act=act)
    plain = lambda: int8_gemm.w8a8_gemm_reference(x, w["w_q"], w["w_scale"], b, act=act)
    xq = int8_gemm.quantize_tokens_reference(x)[0] if m > 16 and m % 8 == n % 8 == 0 else None
    library = (lambda: torch._int_mm(xq, w["w_q"])) if xq is not None else None
    cost = (nbytes(x, w["w_q"], w["w_scale"], *([b] if bias else [])) + m * n * x.element_size(),
            2.0 * m * k * n, torch.int8)
    return run, plain, library, cost, x, w, b


def check_k13(dev, gen, label, m, k, n, bias, act, dtype, iters):
    """K13a bit for bit (its launch quantize_tokens_plan's) and K13b
    against their plain versions at one product [m, k] x [k, n] of a
    ViT-H block (random x and weights in the W8A8 format); K13b within
    one bf16 step (fp32: rtol 1e-6) of the output (erff / tanhf last
    places), and equal to its first design (w8a8_gemm_mma_sync) bit for
    bit. Then (iters > 0) both kernels'
    numbers: K13a has no one-call library counterpart, K13b's is
    torch._int_mm on the same codes; K13b's first design is timed beside."""
    grun, gplain, library, gcost, x, w, b = k13b_case(dev, gen, m, k, n, bias, act, dtype)
    qrun = lambda: int8_gemm.quantize_tokens(x)
    qplain = lambda: int8_gemm.quantize_tokens_reference(x)
    first = lambda: int8_gemm.w8a8_gemm_mma_sync(x, w["w_q"], w["w_scale"], b, act=act)
    (xq, sx), y, y_first = qrun(), grun(), first()
    torch.cuda.synchronize()
    (wq, ws), qplain_ms = host_ms(qplain)
    want, gplain_ms = host_ms(gplain)
    same = torch.equal(xq, wq) and torch.equal(sx, ws)
    same_plan = (int8_gemm.quantize_tokens_info(m, k, dtype)
                 == int8_gemm.quantize_tokens_plan(m, k, dtype))
    same_first = torch.equal(y, y_first)
    max_err, mean_err = errors(y, want)
    scale = float(want.float().abs().max())
    tol = (1e-6 if dtype == torch.float32 else 2.0 ** -8) * scale
    ok = same and same_plan and same_first and max_err <= tol
    route = int8_gemm.w8a8_gemm_plan(m, k, n)["route"]
    log(f"  quantize_tokens / w8a8_gemm {label} {str(dtype)[6:]} ({route}): codes and scales "
        f"identical={same}; K13a's launch the plan's={same_plan}; equal to the first design="
        f"{same_first}; output max_abs={max_err:.3e} mean_abs={mean_err:.3e} (limit "
        f"{tol:.3e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K13a/K13b disagree with their plain versions or K13b with its "
                             f"first design ({label})")
    if iters == 0:
        return None, None
    del want, y_first
    qcost = (nbytes(x) + m * k + 4 * m, 4.0 * m * k, torch.float32)
    gres = dict(max_abs_err=max_err, **measure(f"w8a8_gemm {label}", grun, gplain, library,
                                               gcost, iters, 4, gplain_ms))
    log(f"  w8a8_gemm {label}: the first design (mma.sync) first_design_ms="
        f"{cuda_ms(first, iters):.4f}")
    return (dict(max_abs_err=0.0, **measure(f"quantize_tokens {label}", qrun, qplain, None,
                                            qcost, iters, 4, qplain_ms)), gres)


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
    # more rows, from a generator of their own (the checks above and below
    # see the draws they always saw): the 7B step at 4 rows, and batches
    # whose rows once outgrew K12's shared memory
    more = torch.Generator(device=dev).manual_seed(seed + 41)
    check_k12(dev, more, "7B int4x 4 rows", 4, 32, 128, 512, 480, True, 11008, "silu", bf16, 20)
    check_k12(dev, more, "7B int4x 32 rows", 32, 32, 128, 512, 480, True, 11008, "silu", bf16, 0)
    check_k12(dev, more, "13B int4x 16 rows", 16, 40, 128, 512, 480, True, 13824, "silu", bf16,
              0)
    torch.cuda.empty_cache()
    # the four products of a ViT-H block for 2 images at 1024^2: a windowed
    # block's qkv and proj take 2 x 25 windows of 14 x 14 (the 64 x 64 grid
    # padded to 70 x 70): 9800 rows; the MLP (and a global block) 8192 rows
    for label, m, k, n, bias, act in (("ViT-H qkv", 9800, 1280, 3840, True, None),
                                      ("ViT-H proj", 9800, 1280, 1280, False, None),
                                      ("ViT-H fc1", 8192, 1280, 5120, True, "gelu_exact"),
                                      ("ViT-H fc2", 8192, 5120, 1280, False, None)):
        # K13a's time at fc2's input [8192, 5120] is logged here too; its
        # kernel alone at fc1 and fc2 in phase 2g
        qres, gres = check_k13(dev, gen, label, m, k, n, bias, act, bf16, 20)
        if label == "ViT-H fc1":
            results.update(quantize_tokens=qres, w8a8_gemm=gres)
        torch.cuda.empty_cache()
    check_k13(dev, gen, "ragged", 37, 96, 20, True, "gelu_tanh", f32, 0)
    check_k13(dev, gen, "ragged bf16", 130, 256, 388, True, "gelu_tanh", bf16, 0)
    # K % 16 != 0: TMA cannot take the rows, the first design runs
    check_k13(dev, gen, "ragged K=100", 37, 100, 20, True, None, f32, 0)
    check_k13(dev, gen, "ragged bf16 K=260", 130, 260, 388, False, "gelu_exact", bf16, 0)
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
    near-tied token (phase 3b's greedy run of the 1B format holds; this
    request's speculative run parts at the prefill's first W8A8 product),
    so the 1B format's speculative run is reported, with the first code on
    which the card parts from the CPU, which must lie on a rounding edge
    (w8a8_edge), and the int8_flat cache is held with dense weights."""
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
        cpu_kw = {k: to_device(v, "cpu") for k, v in kw.items()}
        for f in KERNELS:
            f.launches = 0
        with _Quantizers() as card_codes:
            card = walkgpt.generate_and_segment(params, cfg, device=dev, **kw)
        launched = {f.__name__: f.launches for f in KERNELS if f.launches}
        t0 = time.perf_counter()
        with _Quantizers() as cpu_codes:
            cpu = walkgpt.generate_and_segment(cpu_params, cfg, device="cpu", **cpu_kw)
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
        if not held and not same:
            w8a8_edge(params, cfg, dev, kw, card_codes.records, cpu_codes.records)
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


# ---------------------------------------------------------------------------
# phase 3c's W8A8 report: where the card and the CPU first part
# ---------------------------------------------------------------------------

class _Quantizers:
    """Records, in call order, every int8 code of the W8A8 path's quantizers
    with the value it was rounded from: nn.quantize_a8 (every W8A8 product),
    int4.quantize_rows (K7's plain activation and per-tile requantize),
    fa.banded_q8_chunk (K8's plain per-head q) and llm._quant_rows (the
    int8_flat cache rows). With plain=True the kernels of the path (K1-K3,
    K7, K8) take their plain versions on CUDA tensors, so that every code is
    seen on the card as on the CPU. A context manager; records are on the
    host."""

    def __init__(self, plain=False):
        self.plain, self.records, self._saved = plain, [], []

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def _add(self, name, pre, codes):
        self.records.append((name, pre.detach().float().cpu(), codes.detach().cpu()))

    def __enter__(self):
        a8, rows, band, cache = nn.quantize_a8, int4.quantize_rows, fa.banded_q8_chunk, llm._quant_rows

        def q_a8(x):
            xq, sx = a8(x)
            one = torch.ones((), device=x.device)
            inv = (127.0 * one / x.abs().amax(-1, keepdim=True).float().clamp_min(1e-8)).to(x.dtype)
            self._add("nn.quantize_a8", x * inv, xq)
            return xq, sx

        def q_rows(x):
            xq, sx = rows(x)
            self._add("int4.quantize_rows", x.float() * (torch.ones((), device=x.device) / sx), xq)
            return xq, sx

        def q_band(q, *, n_kv, head_dim):
            q8, qs = band(q, n_kv=n_kv, head_dim=head_dim)
            b, tc, hd = q.shape
            qf = q.float().reshape(b, tc, n_kv, hd // head_dim // n_kv, head_dim)
            self._add("fa.banded_q8_chunk", qf / qs[..., None], q8)
            return q8, qs

        def q_cache(x, qmax=127):
            q, scale = cache(x, qmax)
            self._add("llm._quant_rows", x.float() / scale.float()[..., None], q)
            return q, scale
        self._patch(nn, "quantize_a8", q_a8)
        self._patch(int4, "quantize_rows", q_rows)
        self._patch(fa, "banded_q8_chunk", q_band)
        self._patch(llm, "_quant_rows", q_cache)
        if self.plain:
            mlp8 = int4.fused_mlp_int8_reference
            self._patch(fa, "_flash_fwd", fa.flash_attention_reference)
            self._patch(fa, "_window_fwd", fa.sam_window_attention_packed_reference)
            self._patch(fa, "_sam_fwd", fa.sam_flash_attention_reference)
            self._patch(llm, "decode_attention_q_chunk", fa.decode_attention_q_chunk_reference)
            self._patch(int4, "fused_mlp_int8", lambda p, x, act: (
                None if x[..., 0].numel() > int4.FUSED_MLP_MAX_ROWS else mlp8(p, x, act)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        return False


def first_code_difference(card, cpu):
    """The first int8 code, in call order, on which two runs' records differ:
    None when every code of the shorter run agrees, else a dict with the
    quantizer, the call's index and shape, the element, the values before
    rounding on the card and the CPU, the nearest .5 boundary and the
    CPU value's distance from it, and that call's largest card-vs-CPU
    difference of values before rounding (its fp32 drift), also in units of
    the fp32 spacing at the boundary."""
    for i, ((name, pre_a, codes_a), (name_b, pre_b, codes_b)) in enumerate(zip(card, cpu)):
        if name != name_b or codes_a.shape != codes_b.shape:
            return dict(quantizer=f"{name} / {name_b}", call=i, shape=tuple(codes_a.shape),
                        diverged="the call sequences differ")
        diff = (codes_a != codes_b).nonzero()
        if not len(diff):
            continue
        idx = tuple(diff[0].tolist())
        a, b = float(pre_a[idx]), float(pre_b[idx])
        edge = math.floor(min(a, b)) + 0.5
        drift = float((pre_a - pre_b).abs().max())
        ulp = 2.0 ** (math.frexp(abs(edge))[1] - 24)        # fp32 spacing at the boundary
        return dict(quantizer=name, call=i, calls=len(cpu), shape=tuple(codes_a.shape),
                    element=idx, n_differ=len(diff), card_pre=a, cpu_pre=b,
                    card_code=int(codes_a[idx]), cpu_code=int(codes_b[idx]), boundary=edge,
                    distance=abs(b - edge), drift=drift, drift_ulps=drift / ulp)
    return None


def spliced_requests(params, cfg, ids, mask, images, row_image_idx):
    """Each prompt row's spliced timeline (its valid part) as a [T, H]
    request for the continuous batcher, and the image features
    ([B, g, g, C]) for its masks."""
    feats, sam_tokens = walkgpt.encode_sam(params, cfg, images)
    vis = walkgpt.visual_tokens(params, cfg, sam_tokens)[row_image_idx]
    sp = walkgpt.splice_visual(params, cfg, ids, vis, attention_mask=mask)
    lens = sp.attention_mask.sum(-1).tolist()
    return [sp.embeds[r, :n] for r, n in enumerate(lens)], feats


def seg_masks(params, cfg, finished, feats, image_of):
    """Each Finished request's [SEG] hidden states -> CTP -> the SAM mask
    decoder on its image's features: {request id: low-res mask logits}."""
    out = {}
    dev = feats.device
    for f in finished:
        n = f.seg_hidden.shape[0]
        if not n:
            continue
        hid = torch.from_numpy(f.seg_hidden).to(dev, params["llm"]["embed_tokens"]["w"].dtype)
        emb = ctp_apply(params["ctp"][0], hid)
        img = feats[image_of[f.request_id]]
        low, _ = sam.decode_masks(params["sam"], walkgpt.sam_config(cfg),
                                  img.expand(n, *img.shape), text_embeds=emb[:, None],
                                  multimask_output=False)
        out[f.request_id] = low
    return out


def alone(req):
    """One request's timeline [T, H] as greedy_generate's batch of one
    ([1, T, H] embeds, [1, T] mask), unpadded as tests/test_serving.py
    passes it. Its decode then writes token s at slot T + s, as the
    batcher's slot does: K4 rounds alpha and p to bf16 per DECODE_BLOCK
    block of the cache, so the same keys at other slots (a prompt padded
    to the bucket puts greedy_generate's decode keys in a later block)
    give another rounding, not the same function."""
    return req[None], torch.ones((1, req.shape[0]), dtype=torch.bool, device=req.device)


@torch.inference_mode()
def alone_in_pool(params, cfg, req, prompt_len, max_len, slots, budget, eos_id, flash_fn):
    """One request [T, H] decoded greedily with the continuous batcher's
    arithmetic and none of its bookkeeping (slots, segments, admits,
    harvests): the prompt right-padded to prompt_len and prefilled at that
    row count, batch 1, into an int4_flat cache of max_len slots; then
    `slots` copies of the request decode together, as a full pool does, so
    every product runs at the batcher's shapes; each token's K/V lands at
    the request's own length. Returns the first copy's tokens, up to
    `budget` or EOS (included), and the prefill's hidden states [T, H]."""
    t, h = req.shape
    dev = req.device
    embeds = torch.zeros((1, prompt_len, h), dtype=req.dtype, device=dev)
    mask = torch.zeros((1, prompt_len), dtype=torch.bool, device=dev)
    embeds[0, :t], mask[0, :t] = req, True
    cache = llm.init_kv_cache(cfg, 1, max_len, dtype=req.dtype, device=dev, quant="int4",
                              layout="flat")
    hidden, cache = llm.forward(params, cfg, embeds, attention_mask=mask, kv_cache=cache,
                                flash_fn=flash_fn)
    pool = {name: buf.repeat_interleave(slots, dim=1) if torch.is_tensor(buf) else buf
            for name, buf in cache.items()}                  # axis 1 is the batch
    pick = lambda hid: llm.lm_logits(params, cfg, hid).float().argmax(-1)
    tok = pick(hidden[:, t - 1]).expand(slots)
    clen = torch.full((slots,), t, dtype=torch.long, device=dev)
    key_pos = torch.arange(max_len, device=dev)[None]
    out = []
    for _ in range(budget):
        out.append(int(tok[0]))
        if out[-1] == eos_id:
            break
        x = llm.embed(params, tok)[:, None].to(req.dtype)
        hid, pool = llm.decode_step(params, cfg, pool, x, clen, key_pos <= clen[:, None])
        tok = pick(hid[:, 0])
        clen = clen + 1
    return out, hidden[0, :t]


def phase_serving_parity(dev, seed):
    """The continuous-batching server at demo_config in fp32 over four slot
    pools: the fp32 and int8 heads layouts and the int8_flat cache (dense
    weights), and the int4_flat cache (the 7B format, float SAM blocks).
    Six spliced requests (3 prompt rows, each twice) through 2 slots with
    per-request budgets, the card against the CPU: the same Finished order,
    tokens and budgets, [SEG] hidden states within 1e-4 (within
    SERVE_FLAT_HIDDEN_REL of their scale over the flat pools), masks (CTP ->
    sam.decode_masks) within 1e-3; and on the card each request against
    greedy_generate of that request alone (alone() says why unpadded) on the
    same cache format."""
    log("== phase 3e: demo_config fp32 serving (continuous batcher), the card against the CPU")
    base = demo_config().replace(use_flash_attention=True)
    budgets = [16, 9, 12, 5, 16, 11]
    flash_fn = lambda q, k, v, kv: fa.flash_attention(q, k, v, True, key_valid=kv)
    for label, fmt, kv in (("dense, heads fp32 pool", None, ""),
                           ("dense, heads int8 pool", None, "int8"),
                           ("dense, int8_flat pool", None, "int8_flat"),
                           ("7B format, float SAM, int4_flat pool", FORMAT_7B, "int4_flat")):
        cfg = base.replace(kv_quant_cache=kv or False)
        if fmt is None:
            params = walkgpt.init(cfg, seed=seed, dtype=torch.float32, device=dev)
        else:
            params = walkgpt.init_quantized(cfg, seed=seed, dtype=torch.float32, device=dev,
                                            **{**fmt, "sam_int8": False})
        cpu_params = to_device(params, "cpu")
        gen = torch.Generator(device=dev).manual_seed(seed + 10)
        s = cfg.sam.img_size
        images = torch.randn(2, s, s, 3, generator=gen, device=dev)
        ids, mask = prompts(3, [40, 27, 33], 48, cfg.llm.vocab_size, gen, dev)
        rows = torch.tensor([0, 1, 1], device=dev)
        image_of = [0, 1, 1, 0, 1, 1]
        kw = dict(batch_size=2, prompt_len=320, max_new_tokens=16, segment=4, eos_id=-1,
                  max_segs_per_answer=8, kv_quant=kv)
        runs = {}
        for where, p in (("card", params), ("cpu", cpu_params)):
            on = torch.device(where if where == "cpu" else dev)
            reqs, feats = spliced_requests(p, cfg, ids.to(on), mask.to(on), images.to(on),
                                           rows.to(on))
            reqs = reqs * 2
            if where == "card":           # [SEG]: the token a probe run emits most
                probe = serving.ContinuousBatcher(p["llm"], cfg.llm, flash_fn=flash_fn,
                                                  device=on, **kw).run(reqs, budgets)
                vals, counts = torch.unique(torch.tensor(sum((f.tokens for f in probe), [])),
                                            return_counts=True)
                seg = int(vals[counts.argmax()])
                for f in KERNELS:
                    f.launches = 0
            batcher = serving.ContinuousBatcher(p["llm"], cfg.llm, flash_fn=flash_fn,
                                                seg_token_ids=(seg,), device=on, **kw)
            fin = batcher.run(reqs, budgets)
            if where == "card":
                launched = {f.__name__: f.launches for f in KERNELS if f.launches}
                alone_ok = True
                for f in fin:                # each request alone through greedy_generate
                    embeds, m = alone(reqs[f.request_id])
                    res = generate.greedy_generate(p["llm"], cfg.llm, embeds, m,
                                                   max_new_tokens=budgets[f.request_id],
                                                   eos_id=-1, flash_fn=flash_fn, kv_quant=kv)
                    alone_ok &= f.tokens == res.tokens[0, :int(res.lengths[0])].tolist()
            runs[where] = (fin, seg_masks(p, cfg, fin, feats, image_of))
        (card, card_masks), (cpu, cpu_masks) = runs["card"], runs["cpu"]
        order = [f.request_id for f in card] == [f.request_id for f in cpu]
        same = order and all(a.tokens == b.tokens and len(a.tokens) == budgets[a.request_id]
                             for a, b in zip(card, cpu))
        hid_err = max([float(abs(a.seg_hidden - b.seg_hidden).max()) for a, b in zip(card, cpu)
                       if a.seg_hidden.shape == b.seg_hidden.shape and a.seg_hidden.size] or [0.0])
        hid_scale = max([float(abs(b.seg_hidden).max()) for b in cpu if b.seg_hidden.size] or [0.0])
        hid_limit = SERVE_FLAT_HIDDEN_REL * max(1.0, hid_scale) if kv.endswith("flat") else 1e-4
        hid_same = all(a.seg_hidden.shape == b.seg_hidden.shape for a, b in zip(card, cpu))
        mask_err = max([float((card_masks[r].cpu() - cpu_masks[r]).abs().max())
                        for r in cpu_masks] or [0.0])
        n_seg = sum(f.seg_hidden.shape[0] for f in card)
        need = {"flash_attention"} | ({"decode_attention_q"} if kv.endswith("flat") else set()) \
            | ({"int4_matmul_pallas", "fused_mlp_int4"} if fmt else set())
        log(f"  {label}: completion order {[f.request_id for f in card]} identical={order}; "
            f"tokens and budgets identical={same}; [SEG] rows {n_seg} (shapes identical="
            f"{hid_same}) max_abs={hid_err:.3e} (scale {hid_scale:.3g}, limit {hid_limit:.3e}); "
            f"masks of {len(cpu_masks)} requests max_abs="
            f"{mask_err:.3e}; each request equals greedy_generate alone on the card: {alone_ok}; "
            f"kernel launches {launched}")
        if not (same and hid_same and n_seg and hid_err <= hid_limit and mask_err <= 1e-3
                and alone_ok
                and need <= set(launched)):
            raise AssertionError(f"demo_config serving {label}: the card and the CPU disagree")
        del params, cpu_params


def w8a8_edge(params, cfg, dev, kw, card_records, cpu_records):
    """Where a W8A8 run on the card first parts from the CPU's: the first int8
    code, in call order, on which the two differ (the codes the kernels
    quantize inside, K7's and K8's, are seen by running the plain versions on
    the card when the others all agree). Reported with its values before
    rounding; raises unless they straddle the code's .5 boundary within the
    call's card-vs-CPU fp32 drift and that drift is below a thousandth of a
    code step, i.e. unless it is a rounding edge."""
    seen = {name for name, _, _ in card_records}
    where = "kernels on the card"
    first = first_code_difference(card_records, [r for r in cpu_records if r[0] in seen])
    if first is None:
        with _Quantizers(plain=True) as plain:
            walkgpt.generate_and_segment(params, cfg, device=dev, **kw)
        where = "plain versions on the card"
        first = first_code_difference(plain.records, cpu_records)
    edge = first is not None and "diverged" not in first and (
        min(first["card_pre"], first["cpu_pre"]) < first["boundary"]
        < max(first["card_pre"], first["cpu_pre"])
        and first["distance"] <= first["drift"] <= 1e-3)
    log(f"    where the card ({where}) first parts from the CPU: {json.dumps(first)}; a "
        f"rounding edge (values straddle the .5 boundary within the call's fp32 drift, "
        f"drift below 1e-3 of a code step): {edge}")
    if not edge:
        raise AssertionError("W8A8 speculative decode: the card parts from the CPU at a code "
                             "that is not on a rounding edge")


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
                fused=False, fused_layer_tail=False, serve=False):
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
    kernels, pre_kernels = {}, {}
    devices = replay(params, cfg, kw, lambda fn: profiled(fn, kernels),
                     prefill_timer=lambda fn: profiled(fn, pre_kernels))[0]
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
    log_shares(f"LLM prefill (wall_ms={walls['prefill']:.1f})", pre_kernels, devices["prefill"],
               ("K1",))
    flat = cfg.kv_quant_cache in ("int8_flat", "int4_flat")
    names = ("K1",) + (("K4",) if flat else ()) + quant_shares(params)
    log_shares(f"greedy request, replayed (decode per step: wall_ms="
               f"{walls['decode'] / max_new_tokens:.2f} device_ms="
               f"{devices['decode'] / max_new_tokens:.2f} device_busy="
               f"{devices['decode'] / walls['decode']:.3f})", kernels, request_dev, names)
    encode_shares(params, cfg, kw)
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
    if serve:
        t0 = time.perf_counter()
        launches = add(launches, phase_serving(dev, seed, params, cfg))
        log(f"  serving part: {time.perf_counter() - t0:.1f} s")
    return launches


# the profiler's kernel names (a part of them) of the kernels whose share of
# a phase's device time phases 4 and 5 print: the problem objects of the
# bf16 tensor-core kernels (K2b's with its delta kernel), K5's kernel, K6's
# and K7's three launches each
# (each with a tile sum of its own), and the chunk engine's rule for K4 (a
# key mask) and K8 (a causal chunk)
SHARES = {"K1": ("::FlashMma",), "K2": ("::WindowMma",), "K3": ("::GlobalMma",),
          "K1b": ("::FlashBwdMma",), "K2b": ("::WindowBwdMma", "row_dot_kernel"),
          "K3b": ("::GlobalBwdMma",),
          "K4": ("KeyMask",), "K5": ("int4_mm_stream",),
          "K6": ("mlp4_gate_up", "mlp4_down", "mlp4_sum_tiles"),
          "K7": ("mlp8_gate_up", "mlp8_down", "mlp8_sum_tiles"), "K8": ("CausalChunk",)}


def quant_shares(params, speculative=False):
    """The short names of K5 (int4 q/k/v or head), K6 (int4 MLP: greedy steps
    only) and K7 (W8A8 MLP) where the params' format runs them."""
    layer = params["llm"]["layers"][0]
    k5 = "qkv4" in layer["attn"] or "w_p4" in params["llm"]["lm_head"]
    k6 = int4.mlp_is_int4(layer["mlp"]) and not speculative
    return ("K5",) * k5 + ("K6",) * k6 + ("K7",) * int4.mlp_is_w8a8(layer["mlp"])


def log_shares(label, kernels, dev_ms, names):
    """Each named kernel's device ms and share of dev_ms, from a profiled
    run's `kernels` ({name: ms}); fails if one of them took no time."""
    parts = []
    for short in names:
        ms = sum(v for n, v in kernels.items() if any(k in n for k in SHARES[short]))
        parts.append(f"{short} {ms:.2f} ms ({ms / dev_ms:.1%})")
        if ms <= 0:
            raise AssertionError(f"{label}: the profiler saw no {short} time")
    log(f"  {label}: device_ms={dev_ms:.1f}, " + ", ".join(parts))


@torch.inference_mode()
def encode_shares(params, cfg, kw):
    """The warm SAM encode alone under the profiler: K2's and K3's share of
    its device time."""
    kernels = {}
    _, dev_ms = profiled(lambda: walkgpt.encode_sam(params, cfg, kw["images"]), kernels)
    log_shares("SAM encode (2 images), warm, under the profiler", kernels, dev_ms, ("K2", "K3"))


def phase_speculative(params, cfg, kw, greedy_step):
    """Two requests with speculative_k=SPEC_K (prompt-lookup drafts; random
    weights accept almost none), their decode replayed on the host clock and
    under the profiler, then the schedule at force_accept 0 and SPEC_K
    without EOS (every iteration emits exactly force_accept + 1 tokens), on
    the host clock, and at SPEC_K under the profiler too (at 0 each
    iteration is a greedy step)."""
    n_new = kw["max_new_tokens"]
    skw = {**kw, "speculative_k": SPEC_K}
    launches, outs, e2e, cfg = run_requests(
        params, cfg, skw, f"speculative_k={SPEC_K}",
        lambda out: expected_launches(cfg, params, n_new, out.n_iters))
    check_outputs("speculative", outs[1], cfg, n_new, (768, 1024))
    walls, res = replay(params, cfg, kw, host_ms, speculative_k=SPEC_K)
    kernels = {}
    devices = replay(params, cfg, kw, lambda fn: profiled(fn, kernels), speculative_k=SPEC_K)[0]
    it, emitted = res.n_iters, int(res.lengths.max())
    log(f"  speculative warm request (2): end_to_end_ms={e2e[1]:.1f}; replayed decode: "
        f"n_iters={it} emitted={res.lengths.tolist()} wall_ms={walls['decode']:.1f} "
        f"device_ms={devices['decode']:.1f} device_busy={devices['decode'] / walls['decode']:.3f}")
    log(f"    per iteration: wall_ms={walls['decode'] / it:.2f} "
        f"device_ms={devices['decode'] / it:.2f}; per emitted token (longest row): "
        f"wall_ms={walls['decode'] / emitted:.2f} against greedy's wall_ms per step "
        f"{greedy_step:.2f}")
    log_shares(f"speculative request, replayed (decode per iteration: wall_ms="
               f"{walls['decode'] / it:.2f} device_ms={devices['decode'] / it:.2f} device_busy="
               f"{devices['decode'] / walls['decode']:.3f})", kernels, sum(devices.values()),
               ("K8",) + quant_shares(params, speculative=True))
    for accept in (0, SPEC_K):
        res, wall = schedule(params, cfg, kw, accept, host_ms)
        wall = wall - walls["prefill"]
        device = "not measured (one draft per iteration: greedy's step, above)"
        if accept:
            dev_ms = schedule(params, cfg, kw, accept, lambda fn: profiled(fn, {}))[1]
            dev_ms -= devices["prefill"]
            device = f"{dev_ms / n_new:.2f} (decode device_ms={dev_ms:.1f})"
        log(f"  force_accept={accept}: n_iters={res.n_iters} tokens per iteration "
            f"{n_new / res.n_iters:.2f}; per emitted token wall_ms={wall / n_new:.2f} "
            f"(decode wall_ms={wall:.1f}) device_ms={device}")
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


PAVE_QUESTIONS = (
    "Which nearby features seem pedestrian-friendly, and which could make movement unsafe?",
    "Is the sidewalk ahead clear of obstacles?",
    "Where is the nearest crosswalk, and how far away is it?",
    "Describe the walking surface in front of me.",
    "Are any vehicles parked on the sidewalk?",
    "Which objects should a wheelchair user avoid here?",
    "How far is the curb ramp on the left?",
    "Is it safe to cross the street here?")


def pave_like_budgets(rng, n, cap):
    """Answer lengths of the PAVE grammar (the JAX package's
    benchmarks/bench_serving.py): about 60 template tokens and 24 per
    object, 1 to 8 objects, capped."""
    return [int(min(60 + 24 * rng.randint(1, 9), cap)) for _ in range(n)]


def pave_prompt_ids(tok):
    """The llava_v1 prompt of each PAVE question, <image> wrapped in
    <im_start> / <im_end> as bench.py builds it, through the port's copy of
    the byte tokenizer."""
    out = []
    for question in PAVE_QUESTIONS:
        conv = conversation.conv_templates["llava_v1"].copy()
        conv.messages = []
        conv.append_message(conv.roles[0], "<image>\n" + question)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt().replace("<image>", "<im_start><image><im_end>")
        out.append(tokenizer.tokenizer_image_token(prompt, tok))
    return out


def phase_serving(dev, seed, params, cfg, n_images=3, slots=4, max_new=128, segment=32):
    """The continuous-batching server at full width: eight text requests
    (PAVE questions in the llava_v1 template, each paired with one of
    n_images random 1024^2 images, every image encoded once), MSQP and
    splice, then the batcher over an int4_flat pool of `slots` slots with
    PAVE-like budgets; launch counts per admit and per segment held exactly.
    The two requests with the largest budgets token for token against
    alone_in_pool (the batcher's arithmetic, none of its bookkeeping), and
    reported beside greedy_generate of each alone; every [SEG] row through
    CTP, decode_masks and finalize_masks. Then the same requests through
    greedy_generate in waves of `slots`, each wave paying its largest
    budget. Returns the launches of the serving run (encode to masks)."""
    log(f"  serving part: the continuous batcher, {slots} slots, int4_flat pool, 8 requests")
    tok = tokenizer.ByteTokenizer(model_max_length=4096)
    tokenizer.setup_walkgpt_tokens(tok)
    ids = pave_prompt_ids(tok)
    budgets = pave_like_budgets(np.random.RandomState(1), len(ids), max_new)
    spliced_len = max(len(x) for x in ids) - 1 + cfg.visual_tokens
    prompt_len = -(-spliced_len // 256) * 256
    log(f"  budgets {budgets} (PAVE-like, capped at max_new_tokens={max_new}: the production "
        f"budget of 512 is cut to keep the run inside its time limit); llava_v1 prompts of "
        f"{min(map(len, ids))}-{max(map(len, ids))} byte-tokenizer ids, spliced to at most "
        f"{spliced_len} tokens: prompt_len {prompt_len}")
    s = cfg.sam.img_size
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    images = torch.randn(n_images, s, s, 3, generator=gen, device=dev).to(torch.bfloat16)
    flash_fn = lambda q, k, v, kv: fa.flash_attention(q, k, v, True, key_valid=kv)
    n_layers = cfg.llm.num_layers
    for f in KERNELS:
        f.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        encoded = [walkgpt.encode_sam(params, cfg, images[i:i + 1]) for i in range(n_images)]
        reqs = []
        for r, row in enumerate(ids):
            vis = walkgpt.visual_tokens(params, cfg, encoded[r % n_images][1])
            reqs.append(walkgpt.splice_visual(params, cfg, torch.tensor([row], device=dev),
                                              vis).embeds[0])
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    per = {f.__name__: f.launches for f in KERNELS}
    log(f"  {n_images} images encoded once each, 8 requests spliced: wall_ms={enc_ms:.1f}, "
        f"launches {_nonzero(per)}")
    n_glob = len(cfg.sam.global_attn_indexes)
    if (per["sam_window_attention_packed"] != n_images * (cfg.sam.depth - n_glob)
            or per["sam_flash_attention"] != n_images * n_glob):
        raise AssertionError(f"serving: image encode launches {per}")
    gkw = dict(max_new_tokens=max_new, eos_id=2, flash_fn=flash_fn, kv_quant="int4_flat")

    # the waves: greedy_generate over `slots` requests at a time, right-padded
    # to prompt_len, each wave paying its largest budget; their tokens give
    # the [SEG] id (random weights never emit the real one)
    wave_ms, wave_tokens, emitted = 0.0, [], 0
    for w0 in range(0, len(reqs), slots):
        batch = reqs[w0:w0 + slots]
        embeds = torch.zeros((len(batch), prompt_len, batch[0].shape[-1]), dtype=batch[0].dtype,
                             device=dev)
        mask = torch.zeros((len(batch), prompt_len), dtype=torch.bool, device=dev)
        for r, e in enumerate(batch):
            embeds[r, :e.shape[0]], mask[r, :e.shape[0]] = e, True
        n_wave = max(budgets[w0:w0 + slots])
        with torch.inference_mode():
            res, ms = host_ms(lambda: generate.greedy_generate(
                params["llm"], cfg.llm, embeds, mask, **{**gkw, "max_new_tokens": n_wave}))
        wave_ms += ms
        for r in range(len(batch)):
            n = min(int(res.lengths[r]), budgets[w0 + r])
            wave_tokens.append(res.tokens[r, :n])
            emitted += n
    vals, counts = torch.unique(torch.cat(wave_tokens), return_counts=True)
    seg = int(vals[counts.argmax()])
    log(f"  waves of {slots} through greedy_generate: wall_ms={wave_ms:.1f}, "
        f"{emitted} tokens within the budgets, {emitted / wave_ms * 1e3:.1f} tokens/s; "
        f"[SEG] := {seg}, the token the waves emit most")

    batcher = serving.ContinuousBatcher(
        params["llm"], cfg.llm, batch_size=slots, prompt_len=prompt_len, max_new_tokens=max_new,
        segment=segment, eos_id=2, flash_fn=flash_fn, seg_token_ids=(seg,),
        max_segs_per_answer=16, kv_quant="int4_flat", device=dev)
    calls = {"admit": [], "segment": []}
    expect = {"admit": dict(flash_attention=n_layers, int4_matmul_pallas=1),
              "segment": dict(decode_attention_q=segment * n_layers,
                              int4_matmul_pallas=segment * (n_layers + 1),
                              fused_mlp_int4=segment * n_layers)}
    admit, decode = batcher._admit_row, batcher._decode_segment

    def counted(kind, fn, timer):
        def call(*a):
            before = {f.__name__: f.launches for f in KERNELS}
            out, ms = timer(lambda: fn(*a))
            launched = {f.__name__: f.launches - before[f.__name__] for f in KERNELS}
            calls[kind].append((ms, _nonzero(launched)))
            return out
        return call
    batcher._admit_row = counted("admit", admit, host_ms)
    batcher._decode_segment = counted("segment", decode, host_ms)
    fin, wall = host_ms(lambda: batcher.run(reqs, budgets))
    launches = {f.__name__: f.launches for f in KERNELS}
    bad = [(kind, l) for kind in calls for _, l in calls[kind] if l != expect[kind]]
    seg_walls = [ms for ms, _ in calls["segment"]]
    n_tok = sum(len(f.tokens) for f in fin)
    log(f"  continuous batcher: wall_ms={wall:.1f} for {len(fin)} requests, {n_tok} tokens, "
        f"{n_tok / wall * 1e3:.1f} tokens/s over the pool; {len(calls['admit'])} admits "
        f"(wall_ms mean {np.mean([ms for ms, _ in calls['admit']]):.1f}), "
        f"{len(seg_walls)} segments of {segment} steps (wall_ms mean {np.mean(seg_walls):.1f}, "
        f"per step {np.mean(seg_walls) / segment:.2f}); completion order "
        f"{[f.request_id for f in fin]}; launches per admit and per segment as expected: "
        f"{not bad}")
    if bad:
        raise AssertionError(f"serving: launches per call {bad[:2]}, expected {expect}")
    # the device time of a segment: the first `slots` requests again, two
    # full segments each under the profiler (the same pool, every slot busy)
    seg_dev, adm_dev, seg_kernels, adm_kernels = [], [], {}, {}
    batcher._admit_row = lambda *a: (lambda r: (adm_dev.append(r[1]), r[0])[1])(
        profiled(lambda: admit(*a), adm_kernels))
    batcher._decode_segment = lambda *a: (lambda r: (seg_dev.append(r[1]), r[0])[1])(
        profiled(lambda: decode(*a), seg_kernels))
    again = batcher.run(reqs[:slots], [2 * segment] * slots)
    batcher._admit_row = admit
    batcher._decode_segment = decode
    first = {f.request_id: f.tokens for f in fin}
    same = all(f.tokens == first[f.request_id][:2 * segment] for f in again)
    log(f"  {len(seg_dev)} segments of the first {slots} requests again, under the profiler "
        f"(tokens the first run's: {same}): device_ms per segment mean {np.mean(seg_dev):.1f}, "
        f"per step {np.mean(seg_dev) / segment:.2f}; device_busy "
        f"{np.mean(seg_dev) / np.mean(seg_walls):.3f} of the first run's mean segment wall")
    log_shares(f"{len(adm_dev)} admits (device_ms mean {np.mean(adm_dev):.2f})", adm_kernels,
               sum(adm_dev), ("K1",))
    log_shares(f"{len(seg_dev)} segments", seg_kernels, sum(seg_dev), ("K4", "K5", "K6"))

    ok = len(fin) == len(reqs) and all(len(f.tokens) <= budgets[f.request_id] for f in fin)
    top2 = sorted(range(len(reqs)), key=lambda r: -budgets[r])[:2]
    by_id = {f.request_id: f for f in fin}
    max_len = -(-(prompt_len + max_new) // fa.DECODE_BLOCK) * fa.DECODE_BLOCK
    for r in top2:
        want, pre_p = alone_in_pool(params["llm"], cfg.llm, reqs[r], prompt_len, max_len, slots,
                                    budgets[r], 2, flash_fn)
        same = by_id[r].tokens == want
        ok &= same
        # greedy_generate of the request alone: a prefill at its T rows (no
        # bucket) and a decode at a batch of one
        embeds, m = alone(reqs[r])
        with torch.inference_mode():
            res = generate.greedy_generate(params["llm"], cfg.llm, embeds, m,
                                           **{**gkw, "max_new_tokens": budgets[r]})
        a = res.tokens[0, :int(res.lengths[0])].tolist()
        pre_t = res.prefill_hidden[0]
        note = (f"; its prefill's hidden states differ from the bucketed prefill's in "
                f"{int((pre_t != pre_p).sum())} of {pre_t.numel()} values")
        if a != want:
            at = next((i for i, (x, y) in enumerate(zip(a, want)) if x != y),
                      min(len(a), len(want)))
            # the bucketed prefill decoded at a batch of one: where the
            # batch's size alone parts the request from the batcher
            one = alone_in_pool(params["llm"], cfg.llm, reqs[r], prompt_len, max_len, 1,
                                budgets[r], 2, flash_fn)[0]
            at1 = next((i for i, (x, y) in enumerate(zip(one, want)) if x != y), None)
            if at < min(len(a), len(want)):
                with torch.inference_mode():
                    lg = llm.lm_logits(params["llm"], cfg.llm,
                                       res.pred_hidden[0, at:at + 1])[0].float()
                note += (f"; they part at step {at} (greedy_generate's token {a[at]} at logit "
                         f"{float(lg[a[at]])}, the batcher's {want[at]} at "
                         f"{float(lg[want[at]])} there)")
            note += (f"; the bucketed prefill decoded at a batch of 1 parts from the batcher at "
                     f"step {at1}")
        log(f"  request {r} (budget {budgets[r]}): {len(by_id[r].tokens)} tokens, identical to "
            f"the request decoded alone at the batcher's shapes (alone_in_pool): {same}; "
            f"greedy_generate of it alone (reported, not held: another batch size): "
            f"identical {a == want}{note}")
    hw = (768, 1024)
    masks_ok, n_seg = True, 0
    feats = torch.cat([e[0] for e in encoded])
    with torch.inference_mode():
        for f in fin:
            n = f.seg_hidden.shape[0]
            n_seg += n
            if not n:
                continue
            emb = ctp_apply(params["ctp"][0], torch.from_numpy(f.seg_hidden).to(
                dev, params["llm"]["embed_tokens"]["w"].dtype))
            img = torch.full((n,), f.request_id % n_images, device=dev)
            canvas, scores = walkgpt.decode_seg_masks(params, cfg, feats, emb, img,
                                                      torch.tensor([hw] * n_images, device=dev))
            final = walkgpt.finalize_masks(canvas, hw, hw)
            masks_ok &= (final.shape == (n, *hw) and bool(torch.isfinite(final).all())
                         and bool(torch.isfinite(scores).all()))
    log(f"  {n_seg} [SEG] rows through CTP, decode_seg_masks and finalize_masks: finite masks "
        f"of shape (n, {hw[0]}, {hw[1]}): {masks_ok}; batcher {n_tok / wall * 1e3:.1f} tokens/s "
        f"against the waves' {emitted / wave_ms * 1e3:.1f} (no gain is claimed: these are the "
        f"numbers a later benchmark cell starts from)")
    if not (ok and masks_ok and n_seg):
        raise AssertionError("serving at full width: requests, tokens or masks wrong")
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


def phase_window_blocks(dev, seed):
    """K10 on the ViT-H encoder's own activations (the JAX package's
    benchmarks/profile_sam.py:105-118 with the port): the first windowed
    block of the dense WalkGPT-7B encoder (random weights from the seed,
    rel-pos tables drawn at 0.1 instead of init's zeros so that the bias is
    real) for 2 images at 1024^2: ln1, window partition, qkv, heads split
    out as strided views, sam_encoder._rel_projections, then K10, against
    the block's own K2 path (its packed rel projections) and K10's plain
    version; then one backward through K10b with respect to q, k, v and the
    rel tables against K2b's on the same leaves. Every launch count is set
    to 0 here and read at the end."""
    log("== phase 4e: K10 and K10b on a ViT-H windowed block's own activations")
    cfg = walkgpt_7b_config().sam
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    ws, h = cfg.window_size, cfg.num_heads
    c = cfg.embed_dim
    d = c // h
    enc = sam_encoder.init(g, cfg, dtype=torch.bfloat16)
    blk = enc["blocks"][0]
    for name in ("rel_pos_h", "rel_pos_w"):
        blk[name] = 0.1 * torch.randn(blk[name].shape, generator=g, device=dev).bfloat16()
    images = torch.randn(2, cfg.img_size, cfg.img_size, 3, generator=g, device=dev)
    for f in KERNELS:
        f.launches = 0
    with torch.no_grad():
        x = nn.conv2d(enc["patch_embed"], images.bfloat16(),
                      stride=(cfg.patch_size, cfg.patch_size), padding="VALID")
        x = x + enc["pos_embed"].to(x.dtype)
        xw, _ = attention.window_partition(nn.layer_norm(blk["ln1"], x), ws)
        bw = xw.shape[0]
        qkv = nn.linear(blk["qkv"], xw.reshape(bw, ws * ws, c))
    q, k, v = (attention.split_heads(t, h) for t in qkv.split(c, dim=-1))
    rel_h, rel_w = sam_encoder._rel_projections(q, blk["rel_pos_h"], blk["rel_pos_w"], ws, ws)
    rel = sam_encoder._rel_projections_packed(qkv[:, :, :c], blk["rel_pos_h"],
                                              blk["rel_pos_w"], ws, h)
    out, lse = fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    block_out, block_lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    plain, plain_lse = fa.sam_window_attention_reference(q, k, v, rel_h, rel_w, ws)
    same = torch.equal(_merge(out), block_out) and torch.equal(lse, block_lse.transpose(1, 2))
    rel_same = torch.equal(torch.cat([_merge(rel_h), _merge(rel_w)], -1), rel)
    block_err = errors(_merge(out), block_out)
    plain_err = errors(out, plain)
    ok = (block_err[0] <= BF16_MAX_ABS and block_err[1] <= BF16_MEAN_ABS
          and plain_err[0] <= BF16_MAX_ABS and plain_err[1] <= BF16_MEAN_ABS
          and errors(lse, plain_lse)[0] <= 1e-2 and bool(torch.isfinite(out.float()).all()))
    log(f"  q/k/v {tuple(q.shape)} bf16 (strided views of the qkv projection), rel "
        f"{tuple(rel_h.shape)}: K10 against the block's K2 path max_abs={block_err[0]:.3e} "
        f"mean_abs={block_err[1]:.3e} (bit for bit: {same}; the two rel projections equal: "
        f"{rel_same}); against its plain version max_abs={plain_err[0]:.3e} "
        f"mean_abs={plain_err[1]:.3e} -> {'ok' if ok else 'FAIL'}")
    # one backward of each path, on the same leaves
    go = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    leaves = [t.detach().clone().requires_grad_() for t in (qkv, rel_h, rel_w)]
    lq, lk, lv = (attention.split_heads(t, h) for t in leaves[0].split(c, dim=-1))
    split_out = fa.sam_window_attention(lq, lk, lv, leaves[1], leaves[2], ws)
    split_grads = torch.autograd.grad(split_out, leaves, go)
    packed_rel = torch.cat([_merge(leaves[1]), _merge(leaves[2])], -1)
    packed_out = fa.sam_window_attention_packed(leaves[0], packed_rel, h, d, ws)
    packed_grads = torch.autograd.grad(packed_out, leaves, _merge(go))
    grads_same = all(torch.equal(a, b) for a, b in zip(split_grads, packed_grads))
    worst = max(errors(a, b)[0] / max(1.0, float(b.float().abs().max()))
                for a, b in zip(split_grads, packed_grads))
    launches = {f.__name__: f.launches for f in KERNELS}
    log(f"  backward to qkv, rel_h and rel_w through K10b against K2b: bit for bit "
        f"{grads_same} (largest difference relative to its gradient {worst:.3e}); launches "
        f"{_nonzero(launches)}")
    if not (ok and (grads_same or worst <= BF16_MAX_ABS)
            and launches["sam_window_attention"] == 2 and launches["sam_window_attention_bwd"] == 1):
        raise AssertionError("ViT-H windowed block: K10/K10b disagree with the K2 path")
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
    log_shares(f"{label} step, warm, under the profiler", kernels, dev_ms, ("K1", "K1b", "K2"))
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
    # the same call again, warm, under the profiler: its device time and
    # the shares of the forwards K2 and K3 and the backwards K2b and K3b,
    # told apart by their problems' names (all four run the tensor cores)
    for t in rel.values():
        t.grad = None
    kernels = {}
    _, dev_ms = profiled(lambda: sam_encoder.apply(
        map_with_path(lambda p, t: rel.get(p, t), enc), cfg.sam, batch["images"][:1],
        use_flash=True).float().square().mean().backward(), kernels)
    log_shares("the same backward warm under the profiler", kernels, dev_ms,
               ("K2", "K3", "K2b", "K3b"))
    log("  its top 5 kernels:")
    for name, k_ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        log(f"    {k_ms:9.2f} ms {k_ms / dev_ms:6.1%}  {name[:110]}")
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


# ---------------------------------------------------------------------------
# phase 6: the PAVE evaluation entry point (runtime/evaluate.main)
# ---------------------------------------------------------------------------

# the CUDA kernel (or its problem) by which the profiler shows each kernel
# of the evaluation's path
EVAL_SYMBOLS = {"flash_attention": "FlashMma", "sam_window_attention_packed": "WindowMma",
                "sam_flash_attention": "GlobalMma", "decode_attention_q": "chunk_walk",
                "int4_matmul_pallas": "int4_mm_stream", "fused_mlp_int4": "mlp4_gate_up"}


# 6a's samples (8 batches of 2: a median batch past the first one's warm-up)
# and 6d's (the CPU's plain versions run them too)
EVAL_SAMPLES, DEMO_SAMPLES = 16, 4


class EvalSpy:
    """While active, evaluate.main's build_model and its two passes
    (_eval_fns) are wrapped: the spy keeps the params and config main built
    and every teacher-forced and generating call's arguments and output."""

    def __enter__(self):
        self.params, self.cfg, self.fwd, self.gen = None, None, [], []
        self._saved = [(evaluate, "build_model", evaluate.build_model),
                       (evaluate, "_eval_fns", evaluate._eval_fns)]
        build, fns = evaluate.build_model, evaluate._eval_fns

        def build_model(*a, **k):
            self.params = build(*a, **k)
            return self.params

        def eval_fns(cfg, device):
            self.cfg = cfg
            fwd, gen = fns(cfg, device)

            def fwd_spy(max_segs):
                f = fwd(max_segs)
                return lambda *a: self._keep(self.fwd, (max_segs,), f, a)

            def gen_spy(*key):
                g = gen(*key)
                return lambda *a: self._keep(self.gen, key, g, a)
            return fwd_spy, gen_spy
        evaluate.build_model, evaluate._eval_fns = build_model, eval_fns
        return self

    @staticmethod
    def _keep(store, key, fn, args):
        out = fn(*args)
        store.append((key, fn, args, out))
        return out

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def eval_argv(root, out, size, precision, max_new, samples, batch=2):
    return ["--val_dataset", "PAVE|val", "--dataset_dir", root, "--model_size", size,
            "--quant", "int4x", "--kv_cache", "int4_flat", "--sam_quant", "int8",
            "--precision", precision, "--val_batch_size", str(batch),
            "--max_new_tokens", str(max_new), "--max_samples", str(samples), "--no_console_text",
            "--save_responses_path", out]


def check_responses(label, path, n_questions):
    data = json.load(open(path))
    ok = (len(data) == n_questions
          and all(d["response"].startswith("Question: ") and "| Answer:" in d["response"]
                  for d in data))
    log(f"  {label}: {len(data)} responses for {n_questions} questions, each 'Question: ... "
        f"| Answer: ...': {ok}; first: {data[0]['response'][:160]!r}")
    if not ok:
        raise AssertionError(f"{label}: the responses JSON is malformed")


def phase_eval(dev, seed):
    """6a: evaluate.main at WalkGPT-7B int4x on a synthetic manifest; 6b:
    its first batch against generate_and_segment called directly (also with
    precomputed_sam, under the profiler), its device IoU counts against the
    host's, each real row against the row alone (logged); 6c: the SAM
    encoder's block_runs layout against blocks; 6d: validate at demo_config
    in the same format, the card against the CPU. Returns the launches of
    6a's run."""
    log("== phase 6: the PAVE evaluation entry point (runtime/evaluate.main)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as root:
        samples = synthetic_pave.write_manifest(os.path.join(root, "data"), EVAL_SAMPLES,
                                                seed=seed, height=480, width=640)
        n_q = [len(s["question"]) if isinstance(s["question"], list) else 1 for s in samples]
        n_questions = sum(n_q)
        native = native_loader.available()
        log(f"  manifest: {EVAL_SAMPLES} samples, {n_questions} questions, .pt label maps 480 x "
            f"640 (ids and 255), no frames (the dummy-image path); native preprocessing: "
            f"{native}")
        if not native:
            raise AssertionError("the native preprocessing library did not build or load")
        out = os.path.join(root, "responses_7b.json")
        for f in KERNELS:
            f.launches = 0
        with EvalSpy() as spy, PlainSpy() as plain:
            t0 = time.perf_counter()
            res = evaluate.main(eval_argv(os.path.join(root, "data"), out, "7b", "bf16", 64,
                                          EVAL_SAMPLES))
            wall = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in KERNELS}
        total = nn.count_params(spy.params)
        log(f"  6a: {card}; WalkGPT-7B int4x + int4_flat + int8 SAM, bf16, {EVAL_SAMPLES} "
            f"images, 2 a batch ({len(spy.gen)} batches), 64 new tokens: images/s "
            f"{res['images_per_sec']:.4f}, steady images/s {res['images_per_sec_steady']:.4f}; "
            f"parameters (count_params) {total:,}; main "
            f"{wall:.1f} s (model build included)")
        line = evaluate.format_metric_line("PAVE|val", res)
        log(f"  6a metric line: {line}")
        keys = ("giou", "ciou", "ap50", "depth_acc", "depth_mae", "depth_match_rate",
                "depth_block_rate", "depth_n_classes")
        ran = {k: launches[k] for k in EVAL_SYMBOLS}
        log(f"  6a launches: {ran}; plain versions called {plain.calls} times")
        if not (all(k in res for k in keys) and "depth-acc" in line and min(ran.values()) > 0
                and plain.calls == 0):
            raise AssertionError("6a: a metric is missing, a kernel of the path never "
                                 "launched, or a plain version ran")
        check_responses("6a", out, n_questions)
        eval_first_batch(dev, spy)
        eval_block_runs(spy)
        del spy
        torch.cuda.empty_cache()
        eval_card_against_cpu(dev, os.path.join(root, "data"), sum(n_q[:DEMO_SAMPLES]))
        launches = add(launches, phase_clip(dev, os.path.join(root, "data"), card))
    return launches


def eval_first_batch(dev, spy):
    """6b on the CLI's first batch and params: its tokens against
    generate_and_segment called directly (under the profiler, which must
    show K1-K6) and with precomputed_sam; device_mask_counts against the
    host's intersection_and_union on the read-back canvases; each real row
    alone (logged)."""
    params, cfg = spy.params, spy.cfg
    (max_new, max_segs, eos_id, spec, _), _, gargs, cli = spy.gen[0]
    _, images, ids, mask, rows, hw = gargs
    kw = dict(input_ids=ids, attention_mask=mask, row_image_idx=rows, pixel_hw=hw,
              max_new_tokens=max_new, max_segs=max_segs, eos_id=eos_id, speculative_k=spec,
              device=dev)
    run_gen = lambda: walkgpt.generate_and_segment(params, cfg, images=images, **kw)
    (_, fwd, fargs, _) = spy.fwd[0]
    direct, gen_wall = host_ms(run_gen)
    _, fwd_wall = host_ms(lambda: fwd(*fargs))
    kernels = {}
    _, gen_dev = profiled(run_gen, kernels)
    _, fwd_dev = profiled(lambda: fwd(*fargs), kernels)
    seen = {k: any(s in n for n in kernels if is_package_kernel(n))
            for k, s in EVAL_SYMBOLS.items()}
    pre = walkgpt.encode_sam(params, cfg, images)
    split = walkgpt.generate_and_segment(params, cfg, images=None, precomputed_sam=pre, **kw)
    same = [torch.equal(cli.tokens, o.tokens) and torch.equal(cli.lengths, o.lengths)
            for o in (direct, split)]
    log(f"  6b: the CLI's first batch ({ids.shape[0]} rows, {images.shape[0]} images): tokens "
        f"equal generate_and_segment's {same[0]}, with precomputed_sam {same[1]}; the profiler "
        f"shows {seen}")
    log(f"  6b: the first batch replayed, warm: the teacher-forced pass {fwd_wall:.1f} ms wall, "
        f"{fwd_dev:.1f} ms on the card (busy {fwd_dev / fwd_wall:.3f}); generate_and_segment "
        f"{gen_wall:.1f} ms wall, {gen_dev:.1f} ms on the card (busy {gen_dev / gen_wall:.3f}); "
        f"device time by the profiler in a second replay")
    if not (all(same) and all(seen.values())):
        raise AssertionError("6b: the CLI's tokens differ from a direct call, or a kernel of "
                             "the path did not show in the profiler")
    fout, counts = spy.fwd[0][3]
    _, _, _, _, _, frows, gt, fhw = fargs
    pred = fout.pred_masks.float().cpu().numpy()
    gt = gt.cpu().numpy()
    img = frows.cpu().numpy()[fout.seg_rows.cpu().numpy()]
    hws = fhw.cpu().numpy()
    host = np.stack([np.stack(eval_metrics.intersection_and_union(
        (pred[k, :hws[img[k]][0], :hws[img[k]][1]] > 0).astype(np.int64),
        gt[k, :hws[img[k]][0], :hws[img[k]][1]].astype(np.int64), 2, 255))
        for k in range(pred.shape[0])])
    exact = np.array_equal(counts.cpu().numpy(), host)
    log(f"  6b: device_mask_counts of {pred.shape[0]} masks equal the host's "
        f"intersection_and_union exactly: {exact}")
    if not exact:
        raise AssertionError("6b: the device IoU counts differ from the host's")
    real = [int(r) for r in torch.nonzero(mask.sum(1) > 1).flatten()]
    steps = 16
    for r in real:
        i = int(rows[r])
        alone = walkgpt.generate_and_segment(
            params, cfg, images=images[i:i + 1], **{**kw, "input_ids": ids[r:r + 1],
                                                     "attention_mask": mask[r:r + 1],
                                                     "row_image_idx": torch.zeros_like(rows[:1]),
                                                     "pixel_hw": hw[i:i + 1],
                                                     "max_new_tokens": steps})
        a, b = alone.tokens[0, :steps], cli.tokens[r, :steps]
        diff = torch.nonzero(a != b).flatten()
        log(f"  6b: row {r} alone (1 row against {ids.shape[0]}), the first {steps} steps: "
            f"tokens equal {not len(diff)}"
            + (f", first apart at step {int(diff[0])}" if len(diff) else "")
            + " (logged, not held)")


def eval_block_runs(spy):
    """6c: the CLI's SAM encoder (WalkGPT-7B, int8 blocks) in the block_runs
    layout against the blocks layout on one 1024^2 image, bit for bit."""
    cfg, enc = spy.cfg, spy.params["sam"]["image_encoder"]
    image = spy.gen[0][2][1][:1]
    stacked = sam_encoder.stack_for_scan(enc, cfg.sam)
    with torch.inference_mode():
        a = sam_encoder.apply(enc, cfg.sam, image, use_flash=True, fast_gelu=cfg.fast_gelu)
        b = sam_encoder.apply(stacked, cfg.sam, image, use_flash=True, fast_gelu=cfg.fast_gelu)
    same = torch.equal(a, b)
    log(f"  6c: SAM ViT-H (int8 blocks) block_runs {len(stacked['block_runs'])} runs against "
        f"blocks on one {image.shape[1]}^2 image: bit for bit {same}")
    if not same:
        raise AssertionError("6c: the block_runs layout differs from the blocks layout")


def eval_card_against_cpu(dev, data, n_questions):
    """6d: validate at demo_config in the 7B int4x format (fp32, the
    kernels on the card, their plain versions on the CPU), the manifest's
    first DEMO_SAMPLES samples: every batch's generated tokens and lengths
    equal, bit for bit, in the rows of its questions (the bucket's padding
    rows, one live token each and never read, logged), and identical
    responses; the per-mask counts equal once the
    pixels where either logit lies within the mask tolerance of 0 are left
    out (1e-3 with the format's weight-only int8 SAM blocks, phase 3b's
    limit for float SAM blocks; QUANT_MASK_REL of the masks' scale with W8A8
    ones), every other pixel on the same side of 0."""
    args = evaluate.parse_args(eval_argv(data, "", "demo", "fp32", 16, DEMO_SAMPLES))
    conversation.set_default_conversation(args.conv_type)
    tok = tokenizer.ByteTokenizer(args.model_max_length)
    seg = tokenizer.setup_walkgpt_tokens(tok).seg_token_idx
    cfg = evaluate.build_config(args, seg).replace(use_flash_attention=True)
    ds = pave.PAVEDataset(os.path.join(data, "val.jsonl"), os.path.join(data, "labelmap.json"),
                          image_size=cfg.sam.img_size, pad_size=cfg.sam.img_size, is_val=True)
    params = evaluate.build_model(args, cfg, device=dev)
    runs = []
    for where, p in ((dev, params), ("cpu", to_device(params, "cpu"))):
        with EvalSpy() as spy:
            t0 = time.perf_counter()
            res, text = evaluate.validate(args, cfg, p, tok, ds, logger=lambda *_: None,
                                          device=where)
            runs.append((res, text, spy.fwd, spy.gen, time.perf_counter() - t0))
    del params
    (cres, ctext, cfwd, cgen, cs), (hres, htext, hfwd, hgen, hs) = runs
    same_text = json.dumps(ctext) == json.dumps(htext) and len(ctext) == n_questions
    # the rows the harvest reads (one per question) held bit for bit; the
    # padding rows of the 8-row bucket (one live token, never read) logged
    same_tokens, pad_apart = len(cgen) == len(hgen), []
    for (_, _, gargs, c), (_, _, _, h) in zip(cgen, hgen):
        real = gargs[3].sum(1).cpu() > 1
        ct, cl = c.tokens.cpu(), c.lengths.cpu()
        same_tokens &= torch.equal(ct[real], h.tokens[real]) and torch.equal(cl[real],
                                                                              h.lengths[real])
        for r in torch.nonzero(~real).flatten().tolist():
            diff = torch.nonzero(ct[r] != h.tokens[r]).flatten()
            if len(diff):
                pad_apart.append(int(diff[0]))
    w8a8_sam = args.quant == "w8a8"
    near, moved, worst, counts_ok = 0, 0, 0.0, True
    for (_, _, fargs, (co, _)), (_, _, _, (ho, _)) in zip(cfwd, hfwd):
        frows, gt, fhw = (fargs[i].cpu() for i in (5, 6, 7))
        pc, ph = co.pred_masks.float().cpu(), ho.pred_masks.float()
        tol = QUANT_MASK_REL * float(ph.abs().max()) if w8a8_sam else 1e-3
        worst = max(worst, float((pc - ph).abs().max()))
        edge = (pc.abs() <= tol) | (ph.abs() <= tol)
        near += int(edge.sum())
        moved += int(((pc > 0) != (ph > 0)).sum())
        # the pixels near 0 become ignored ones (255) on both sides
        gt_kept = torch.where(edge, 255.0, gt.float())
        counts_ok &= (torch.equal(co.seg_rows.cpu(), ho.seg_rows) and torch.equal(
            eval_metrics.device_mask_counts(pc, gt_kept, ho.seg_rows, frows, fhw),
            eval_metrics.device_mask_counts(ph, gt_kept, ho.seg_rows, frows, fhw)))
    log(f"  6d: demo_config, 7B int4x format, fp32, {DEMO_SAMPLES} samples, "
        f"{args.max_new_tokens} new tokens: tokens and lengths of the question rows of "
        f"{len(cgen)} batches equal {same_tokens}; padding rows apart {len(pad_apart)} (first "
        f"at steps {sorted(set(pad_apart))}; logged, not held); responses identical {same_text} ({len(ctext)}); masks max_abs "
        f"{worst:.3e}; {near} pixels within the tolerance of 0 left out, {moved} on the other "
        f"side of 0; the other pixels' counts equal {counts_ok}; giou card {cres['giou']:.6f} CPU {hres['giou']:.6f} (validate: card "
        f"{cs:.1f} s, CPU {hs:.1f} s)")
    if not (same_tokens and same_text and counts_ok):
        raise AssertionError("6d: the card and the CPU disagree")


# ---------------------------------------------------------------------------
# phase 6e: the CLIP stream; phases 7 and 8: the training CLI and parity_cli
# ---------------------------------------------------------------------------

# 6e's samples at WalkGPT-7B int4x (2 batches of 2)
CLIP_SAMPLES = 4
# the modules of the kernels, whose plain versions (`*_reference`) their
# wrappers call only on CPU tensors
PLAIN_MODULES = (fa, int4, fused_layer, int8_gemm)


class PlainSpy:
    """While active, every plain version of a kernel counts its calls."""

    def __enter__(self):
        self.calls = 0
        self._saved = [(mod, name, getattr(mod, name)) for mod in PLAIN_MODULES
                       for name in dir(mod) if name.endswith("_reference")]

        def counted(fn):
            def call(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return call
        for mod, name, fn in self._saved:
            setattr(mod, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class Patched:
    """Module attributes replaced while active: Patched((mod, name, value), ...)."""

    def __init__(self, *items):
        self.items = items

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self.items]
        for mod, name, value in self.items:
            setattr(mod, name, value)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def smi_line():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def with_kernels(build_config):
    """evaluate.build_config with the kernels' path on (use_flash_attention,
    as phase 6d sets it: demo_config runs the einsum attention by default)."""
    return lambda *a, **k: build_config(*a, **k).replace(use_flash_attention=True)


def phase_clip(dev, data, card):
    """6e: evaluate.main --visual_stream clip at WalkGPT-7B int4x (CLIP
    ViT-L/14-448, phase 6a's flags) on CLIP_SAMPLES samples, 64 new tokens;
    then generate_and_segment(visual_stream="clip") at demo_config in the 7B
    int4x format, the card against the CPU. Returns the 7B run's launches."""
    log("== phase 6e: the CLIP stream")
    t0 = time.perf_counter()
    out = os.path.join(os.path.dirname(data), "responses_clip.json")
    for f in KERNELS:
        f.launches = 0
    with EvalSpy() as spy, PlainSpy() as plain:
        res = evaluate.main(eval_argv(data, out, "7b", "bf16", 64, CLIP_SAMPLES)
                            + ["--visual_stream", "clip"])
    launches = {f.__name__: f.launches for f in KERNELS}
    ran = {k: launches[k] for k in EVAL_SYMBOLS}
    streams = {key[4] for key, _, _, _ in spy.gen}
    clip_in = all(len(args) == 8 and args[6].shape[1:] == (448, 448, 3)
                  for _, _, args, _ in spy.gen)
    log(f"  6e: {card}; WalkGPT-7B int4x, --visual_stream clip (CLIP ViT-L/14-448), bf16, "
        f"{CLIP_SAMPLES} images, 2 a batch ({len(spy.gen)} batches), 64 new tokens: images/s "
        f"{res['images_per_sec']:.4f}, steady images/s {res['images_per_sec_steady']:.4f}; "
        f"parameters (count_params) {nn.count_params(spy.params):,}; streams {streams}, CLIP "
        f"pixels 448^2 passed: {clip_in}; launches {ran}; plain versions called "
        f"{plain.calls} times")
    keys = ("giou", "ciou", "ap50", "depth_acc", "depth_mae")
    n_q = sum(1 for _ in json.load(open(out)))
    if not (all(k in res for k in keys) and streams == {"clip"} and clip_in
            and min(ran.values()) > 0 and plain.calls == 0):
        raise AssertionError("6e: a metric is missing, the CLIP stream did not run, a kernel "
                             "of the path never launched, or a plain version ran")
    check_responses("6e", out, n_q)
    del spy
    torch.cuda.empty_cache()

    # demo_config in the 7B int4x format: the card against the CPU
    cfg = demo_config().replace(use_flash_attention=True, kv_quant_cache="int4_flat")
    params = walkgpt.init_quantized(cfg, seed=5, dtype=torch.float32, device=dev, **FORMAT_7B)
    s = cfg.clip.image_size
    gen = torch.Generator(device=dev).manual_seed(6)
    clip_kw = dict(visual_stream="clip",
                   images_clip=torch.randn(2, s, s, 3, generator=gen, device=dev),
                   clip_resize_hw=torch.tensor([[s, s], [s, s // 2]], device=dev))
    kw, cfg = demo_request(params, cfg, dev, 7, **clip_kw)
    for f in KERNELS:
        f.launches = 0
    with PlainSpy() as plain:
        c = walkgpt.generate_and_segment(params, cfg, device=dev, **kw)
    launched = _nonzero({f.__name__: f.launches for f in KERNELS})
    h = walkgpt.generate_and_segment(to_device(params, "cpu"), cfg, device="cpu",
                                     **to_device(kw, "cpu"))
    sam = walkgpt.generate_and_segment(params, cfg, device=dev,
                                       **{k: v for k, v in kw.items() if k not in clip_kw})
    same = all(torch.equal(getattr(c, k).cpu(), getattr(h, k))
               for k in ("tokens", "lengths", "seg_valid", "seg_rows"))
    log(f"  6e: demo_config, 7B int4x format, fp32, clip stream: tokens, lengths and [SEG] "
        f"rows of the card equal the CPU's {same} ({int(c.seg_valid.sum())} [SEG]); masks "
        f"max_abs {float((c.pred_masks.cpu() - h.pred_masks).abs().max()):.3e} (logged); "
        f"tokens differ from the SAM stream's {not torch.equal(c.tokens, sam.tokens)}; "
        f"launches {launched}; plain versions called on the card {plain.calls}")
    if not (same and plain.calls == 0 and launched.get("fused_mlp_int4")):
        raise AssertionError("6e: the clip stream's card and CPU tokens differ")
    log(f"  CLIP stream: phase {time.perf_counter() - t0:.1f} s")
    return launches


def _scalars(path):
    out = {}
    for line in open(path):
        d = json.loads(line)
        out[(d["tag"], d["step"])] = d["value"]
    return out


TRAIN_TAGS = ("train/loss", "train/ce_loss", "train/mask_bce_loss", "train/mask_dice_loss",
              "train/nce_loss", "train/mask_loss")
METRIC_TAGS = ("metrics/total_secs_per_batch", "metrics/data_secs_per_batch")
VAL_TAGS = ("val/giou", "val/ciou", "val/miou_inclusive", "val/miou_exclusive", "val/miou",
            "val/ap50_inclusive", "val/recall_inclusive")


def _tree_bytes(tree):
    return sum(x.numel() * x.element_size() for x in leaves_with_path(tree).values()
               if isinstance(x, torch.Tensor))


def _same_tree(a, b):
    """Two trees equal bit for bit: tensors (dtype, values), numbers."""
    la, lb = leaves_with_path(a), leaves_with_path(b)
    if list(la) != list(lb):
        return False
    return all(x.dtype == lb[k].dtype and torch.equal(x, lb[k]) if isinstance(x, torch.Tensor)
               else x == lb[k] for k, x in la.items())


def state_bytes_7b(dev, seed):
    """(train state bytes, best checkpoint bytes, count_params) of the 7B
    LoRA run, reckoned from the tree: the bf16 model with its r=8 adapters,
    plus AdamW's two moments of every trainable leaf."""
    params = walkgpt.init(walkgpt_7b_config(), seed=seed, dtype=torch.bfloat16, device=dev)
    count = nn.count_params(params)
    params["llm"] = lora.init_lora(params["llm"], torch.Generator(device=dev).manual_seed(0),
                                   r=8, alpha=16.0)
    mask = leaves_with_path(train.trainable_mask(params, train.TrainConfig()))
    leaves = leaves_with_path(params)
    trainable = sum(x.numel() * x.element_size() for p, x in leaves.items() if mask[p])
    total = _tree_bytes(params)
    del params, leaves
    torch.cuda.empty_cache()
    return total + 2 * trainable, total, count


def phase_train_cli(dev, seed):
    """7a: train_cli.main at WalkGPT-7B full width (LoRA r=8, bf16, PAVE, 2
    images a step, 3 steps, validation on 2 samples), random weights from
    seed 0; its scalars, checkpoint, projector artifact and leaves held;
    s/step, peak memory, checkpoint bytes and seconds. Returns launches."""
    log("== phase 7a: train_cli.main at WalkGPT-7B, full width")
    t_phase = time.perf_counter()
    card = smi_line()
    tmp = tempfile.gettempdir()
    state_b, best_b, count = state_bytes_7b(dev, seed)
    free = shutil.disk_usage(tmp).free
    size = "7b" if free > 1.1 * (state_b + best_b) else "1b"
    log(f"  temporary directory {tmp}: {free:,} bytes free; the 7B train state {state_b:,} "
        f"bytes and the best checkpoint {best_b:,} bytes, reckoned from the tree "
        f"(count_params {count:,}); runs --model_size {size}"
        + ("" if size == "7b" else ": the disk cannot hold both"))
    spy = argparse.Namespace(params=None, saves=[], lora_a=None)
    real_build, real_save, real_lora = evaluate.build_model, checkpoint.save, lora.init_lora

    def build_model(*a, **k):
        spy.params = real_build(*a, **k)
        spy.count = nn.count_params(spy.params)
        spy.sums = {p: (x, float(x.float().sum()))
                    for p, x in leaves_with_path(spy.params).items()
                    if isinstance(x, torch.Tensor)}
        return spy.params

    def save(path, tree):
        t0 = time.perf_counter()
        real_save(path, tree)
        spy.saves.append((path, time.perf_counter() - t0,
                          os.path.getsize(os.path.join(path, checkpoint.PARAMS_FILE))))

    def init_lora(*a, **k):
        out = real_lora(*a, **k)
        spy.lora_a = {p: x.clone() for p, x in leaves_with_path(out).items() if "lora_a" in p}
        return out

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        synthetic_pave.write_manifest(data, 8, seed=seed, height=480, width=640)
        runs = os.path.join(root, "runs")
        argv = ["--model_size", size, "--precision", "bf16", "--dataset", "PAVE", "--lora_r",
                "8", "--batch_size", "2", "--epochs", "1", "--steps_per_epoch", "3",
                "--eval_samples", "2", "--dataset_dir", data, "--log_base_dir", runs]
        for f in KERNELS:
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Patched((evaluate, "build_model", build_model), (checkpoint, "save", save),
                     (lora, "init_lora", init_lora)), PlainSpy() as plain:
            state = train_cli.main(argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {f.__name__: f.launches for f in KERNELS}
        run_dir = os.path.join(runs, "walkgpt_train")
        sc = _scalars(os.path.join(run_dir, "scalars.jsonl"))
        steps_ok = all(math.isfinite(sc.get((t, s), math.nan))
                       for t in TRAIN_TAGS + METRIC_TAGS for s in (1, 2, 3))
        val_ok = all(any(k[0] == t for k in sc) for t in VAL_TAGS)
        sps = sorted(sc[("metrics/total_secs_per_batch", s)] for s in (2, 3))
        latest = open(os.path.join(run_dir, "ckpt_model", "latest")).read()
        state_dir = os.path.join(run_dir, "ckpt_model", latest, "state")
        t0 = time.perf_counter()
        back = checkpoint.load(state_dir, like=state)
        load_s = time.perf_counter() - t0
        same = (back.step == state.step and _same_tree(back.params, state.params)
                and _same_tree(back.opt_state, state.opt_state))
        del back
        torch.cuda.empty_cache()
        state_save = [s for s in spy.saves if s[0] == state_dir]
        best = [s for s in spy.saves if "best_ckpt_model" in s[0]]
        log(f"  7a: {card}; --model_size {size}: {state.step} steps, s/step (median of steps "
            f"2-3) {sps[0] + (sps[1] - sps[0]) / 2:.3f} (steps: "
            + ", ".join(f"{sc[('metrics/total_secs_per_batch', s)]:.3f}" for s in (1, 2, 3))
            + f"); max_memory_allocated {peak:.2f} GB; main {wall:.1f} s with the model "
            f"build, validation and checkpoints; count_params {spy.count:,}")
        log("  7a losses: " + "; ".join(
            f"step {s}: " + " ".join(f"{t.split('/')[1]}={sc[(t, s)]:.5f}" for t in TRAIN_TAGS)
            for s in (1, 2, 3)) + "; val: " + " ".join(
            f"{t.split('/')[1]}={sc[(t, 0)]:.4f}" for t in VAL_TAGS if (t, 0) in sc))
        for path, secs, nb in spy.saves:
            log(f"  7a checkpoint {os.path.relpath(path, run_dir)}: {nb:,} bytes, saved in "
                f"{secs:.2f} s ({nb / secs / 1e9:.2f} GB/s; {card})")
        log(f"  7a: latest names {latest!r}; the state loads back in {load_s:.2f} s "
            f"({state_save[0][2] / load_s / 1e9:.2f} GB/s, warm; {card}) and equals main's bit for "
            f"bit: {same}; every train/* and metrics/* tag finite for steps 1-3: {steps_ok}; "
            f"val/* tags: {val_ok}; best checkpoints {len(best)}")

        # the leaves: frozen ones (the CLIP tower included) unchanged, the
        # LoRA adapters and the trained groups moved
        now = leaves_with_path(state.params)
        mask = leaves_with_path(train.trainable_mask(state.params, train.TrainConfig()))
        frozen_ok = all(now[p] is x and float(x.float().sum()) == c
                        for p, (x, c) in spy.sums.items() if not mask[p])
        clip_ok = all(now[p] is x for p, (x, _) in spy.sums.items() if p.startswith("clip/"))
        moved = {p: not torch.equal(now[p], x) for p, (x, _) in spy.sums.items() if mask[p]}
        lora_a = all(not torch.equal(now["llm/" + p].cpu(), x) for p, x in spy.lora_a.items())
        lora_b = all(bool(x.abs().max() > 0) for p, x in now.items() if "lora_b" in p)
        groups = {g: any(m for p, m in moved.items() if p.startswith(g))
                  for g in ("llm/embed_tokens", "llm/lm_head", "sam/mask_decoder", "ctp/",
                            "msqp/")}
        still = sorted(p for p, m in moved.items() if not m)
        log(f"  7a leaves: frozen ({sum(1 for p in spy.sums if not mask[p])}) unchanged bit for "
            f"bit {frozen_ok}, the CLIP tower among them {clip_ok}; lora_a moved {lora_a}, "
            f"lora_b moved {lora_b}; trained groups moved {groups}; trainable leaves that did "
            f"not move (no gradient, or an update under their bf16 step): {still[:6]}{' ...' if len(still) > 6 else ''}")

        # the projector artifact through evaluate.build_model --projector_ckpt
        proj = os.path.join(run_dir, "ckpt_model", latest, "out_mm_projector")
        pargs = evaluate.parse_args(["--model_size", size, "--precision", "bf16",
                                     "--projector_ckpt", proj])
        tok = tokenizer.ByteTokenizer(2048)
        seg = tokenizer.setup_walkgpt_tokens(tok).seg_token_idx
        reload = evaluate.build_model(pargs, evaluate.build_config(pargs, seg), device=dev)
        proj_ok = all(_same_tree(reload[k], state.params[k]) for k in ("msqp", "mm_projector"))
        del reload
        torch.cuda.empty_cache()
        ran = {k: launches[k] for k in ("flash_attention", "flash_attention_bwd",
                                        "sam_window_attention_packed", "sam_flash_attention")}
        log(f"  7a: the projector artifact (msqp, mm_projector) reloads through "
            f"evaluate.build_model --projector_ckpt equal: {proj_ok}; launches "
            f"{_nonzero(launches)}; plain versions called {plain.calls} times")
        if not (state.step == 3 and latest == "global_step3" and same and steps_ok and val_ok
                and best and frozen_ok and clip_ok and lora_a and lora_b and all(groups.values())
                and proj_ok and min(ran.values()) > 0 and plain.calls == 0):
            raise AssertionError("7a: train_cli.main at full width failed a check")
        del state, spy
        torch.cuda.empty_cache()
    log(f"  training CLI at full width: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_train_cli_parity(dev, seed):
    """7b: train_cli.main at demo_config in fp32 (TF32 off) on the card and
    with --device cpu, from one checkpoint: the LoRA leg (2 steps, then
    --auto_resume --epochs 2 for 2 more) and the QLoRA leg (--quant_base
    int4x, 2 steps, --no_eval). Then phase 8: parity_cli record at
    demo_config in the 7B int4x format on the card and on the CPU from the
    same checkpoint, and compare.

    The steps run with nce_topk None, for phase 3d's reason: the top-k
    refinement of InfoNCE is a hard selection, discontinuous where two SAM
    tokens' weights tie, so a last-place difference of the features can
    move the loss by 1e-2."""
    log("== phase 7b: demo_config fp32 train_cli.main, the card against the CPU")
    t_phase = time.perf_counter()
    tok = tokenizer.ByteTokenizer(2048)
    seg = tokenizer.setup_walkgpt_tokens(tok).seg_token_idx
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        synthetic_pave.write_manifest(data, 4, seed=seed, height=120, width=160)
        # one checkpoint for both devices, in the port's own format; the
        # head's [SEG] column raised so that the runs write masks
        params = walkgpt.init(demo_config(), seed=seed, dtype=torch.float32, device=dev)
        w = params["llm"]["lm_head"]["w"]
        w[:, seg] = 4.0 * w.abs().amax(dim=1)
        weights = os.path.join(root, "weights")
        checkpoint.save(weights, params)
        del params
        common = ["--model_size", "demo", "--precision", "fp32", "--dataset", "PAVE",
                  "--lora_r", "8", "--batch_size", "2", "--steps_per_epoch", "2",
                  "--eval_samples", "1", "--dataset_dir", data, "--weight", weights]
        legs = (("lora", ["--epochs", "1"]), ("lora", ["--epochs", "2", "--auto_resume"]),
                ("qlora", ["--epochs", "1", "--quant_base", "int4x", "--no_eval"]))
        runs = {}
        no_topk = lambda *a, **k: LossWeights(*a, **{"nce_topk": None, **k})
        for where in ("card", "cpu"):
            d = "cuda" if where == "card" else "cpu"
            for f in KERNELS:
                f.launches = 0
            t0 = time.perf_counter()
            states = []
            with Patched((evaluate, "build_config", with_kernels(evaluate.build_config)),
                         (config_module, "LossWeights", no_topk)), PlainSpy() as plain:
                for exp, extra in legs:
                    states.append(train_cli.main(common + extra + [
                        "--exp_name", exp, "--log_base_dir", os.path.join(root, where),
                        "--device", d]))
            runs[where] = dict(states=states, secs=time.perf_counter() - t0,
                               plain=plain.calls,
                               launches=_nonzero({f.__name__: f.launches for f in KERNELS}),
                               lora=_scalars(os.path.join(root, where, "lora", "scalars.jsonl")),
                               qlora=_scalars(os.path.join(root, where, "qlora",
                                                           "scalars.jsonl")))
        card, cpu = runs["card"], runs["cpu"]
        loss_ok, lines = True, []
        for leg, steps in (("lora", (1, 2, 3, 4)), ("qlora", (1, 2))):
            for s in steps:
                pairs = [(card[leg][(t, s)], cpu[leg][(t, s)]) for t in TRAIN_TAGS]
                loss_ok &= all(abs(c - h) <= LOSS_RTOL * abs(h) for c, h in pairs)
                lines.append(f"{leg} step {s}: " + " ".join(
                    f"{t.split('/')[1]}={c:.6f}/{h:.6f}" for t, (c, h) in zip(TRAIN_TAGS, pairs)))
        for line in lines:
            log(f"  {line} (card/CPU)")
        leaf_ok, notes = True, []
        for label, i in (("LoRA after the resumed epoch", 1), ("QLoRA", 2)):
            cs, hs = card["states"][i], cpu["states"][i]
            mask = leaves_with_path(train.trainable_mask(hs.params, train.TrainConfig()))
            cp = {p: x for p, x in leaves_with_path(cs.params).items() if mask.get(p)}
            hp = {p: x for p, x in leaves_with_path(hs.params).items() if mask.get(p)}
            out, worst = _leaf_errors(cp, hp)
            n_el = sum(x.numel() for x in hp.values())
            lr2 = 2 * train.TrainConfig().lr
            leaf_ok &= (cs.step == hs.step and out <= LEAF_OUTLIERS * n_el and worst <= lr2)
            notes.append(f"{label} (step {cs.step}/{hs.step}): {len(hp)} trainable leaves, "
                         f"{n_el} elements, {out} outside rtol {LEAF_RTOL} / atol {LEAF_ATOL}, "
                         f"max_abs {worst:.3e}")
        val = [(card["lora"].get(("val/giou", e)), cpu["lora"].get(("val/giou", e)))
               for e in (0, 1)]
        log("  7b trainable leaves: " + "; ".join(notes) + f"; val/giou per epoch card/CPU "
            f"{val} (logged); card launches {card['launches']}, plain versions called on the "
            f"card {card['plain']}; main's three legs: card {card['secs']:.1f} s, CPU "
            f"{cpu['secs']:.1f} s")
        need = {"flash_attention", "flash_attention_bwd", "sam_window_attention_packed",
                "sam_flash_attention"}
        if not (loss_ok and leaf_ok and card["plain"] == 0 and need <= set(card["launches"])):
            raise AssertionError("7b: train_cli.main on the card and on the CPU disagree")
        log(f"  training CLI, card against CPU: phase {time.perf_counter() - t_phase:.1f} s")
        phase_parity_cli(data, weights)


def phase_parity_cli(data, weights):
    """8: parity_cli record at demo_config in the 7B int4x format, fp32, on
    the card and on the CPU from the same checkpoint; compare must return 0
    (identical tokens, masks within gIoU 1e-3)."""
    log("== phase 8: parity_cli record on the card and on the CPU, compare")
    t0 = time.perf_counter()
    root = os.path.dirname(data)
    base = ["record", "--samples", "3", "--dataset_dir", data, "--model_size", "demo",
            "--precision", "fp32", "--quant", "int4x", "--kv_cache", "int4_flat",
            "--sam_quant", "int8", "--max_new_tokens", "16", "--weight", weights]
    with Patched((evaluate, "build_config", with_kernels(evaluate.build_config))):
        for f in KERNELS:
            f.launches = 0
        with PlainSpy() as plain:
            parity_cli.main(base + ["--out", os.path.join(root, "card.npz"), "--device", "cuda"])
        launched = _nonzero({f.__name__: f.launches for f in KERNELS})
        parity_cli.main(base + ["--out", os.path.join(root, "cpu.npz"), "--device", "cpu"])
    rc = parity_cli.main(["compare", "--a", os.path.join(root, "card.npz"),
                          "--b", os.path.join(root, "cpu.npz")])
    rec = np.load(os.path.join(root, "card.npz"))
    n_masks = sum(rec[f"masks_{i}"].shape[0] for i in range(len(rec["sample_keys"])))
    log(f"  8: compare returned {rc} ({len(rec['sample_keys'])} samples, {n_masks} masks); "
        f"card launches {launched}; plain versions called on the card {plain.calls}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    if not (rc == 0 and plain.calls == 0 and launched.get("decode_attention_q")):
        raise AssertionError("8: the card's and the CPU's recordings differ")


def tie_pick_check(dev, gen):
    """The decode step's token pick (runtime/generate._picker: argmax over a
    row's fp32 logits) at a planted exact tie of two logits in every row, at
    1, 4 and 8 rows (8: the eval's row bucket): does each row pick as it does
    alone, and the first of the tied indices (logged, not held)."""
    v = 32016
    logits = torch.randn(8, v, generator=gen, device=dev).to(torch.bfloat16).float()
    pairs = [(5, 30000), (100, 101), (16000, 16001), (31999, 32015), (0, 31), (7, 8192),
             (4095, 4096), (20000, 20001)]
    for r, (i, j) in enumerate(pairs):
        top = float(logits[r].max()) + 1.0
        logits[r, i] = logits[r, j] = top
    alone = torch.cat([logits[r:r + 1].argmax(-1) for r in range(8)])
    first = torch.tensor([i for i, _ in pairs], device=dev)
    for n in (1, 4, 8):
        pick = logits[:n].argmax(-1)
        log(f"  argmax at a planted tie, {n} rows: each row as alone "
            f"{torch.equal(pick, alone[:n])}, the first tied index {torch.equal(pick, first[:n])}"
            f" (logged, not held)")


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
    numbers.update(phase_window_split_kernels(dev, args.seed))
    torch.cuda.empty_cache()
    phase_routes(dev, args.seed)
    phase_parity(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_quant(dev, args.seed)
    torch.cuda.empty_cache()
    phase_parity_spec(dev, args.seed)
    torch.cuda.empty_cache()
    phase_serving_parity(dev, args.seed)
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
         dict(speculative=True, fused_layer_tail=True, serve=True)),
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
    launches = add(launches, phase_window_blocks(dev, args.seed))
    torch.cuda.empty_cache()
    log(f"  ViT-H windowed block through K10/K10b: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = add(launches, phase_train(dev, args.seed))
    log(f"  training: phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = add(launches, phase_eval(dev, args.seed))
    log(f"  PAVE evaluation: phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    launches = add(launches, phase_train_cli(dev, args.seed))
    torch.cuda.empty_cache()
    phase_train_cli_parity(dev, args.seed)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main paths never launched: {launches}")

    kernels = []
    for name, (source, replaces, *headers) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name], **numbers[name],
                        **({"headers": headers[0]} if headers else {})})
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
