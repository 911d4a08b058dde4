"""SAM ViT image encoder (PyTorch counterpart of walkgpt_tpu/models/sam_encoder.py).

NHWC activations end to end; windows are folded into the batch axis; the
rel-pos bias enters either through the attention kernels (use_flash: K2 for
the windowed blocks over the packed qkv layout, K3 for the global blocks) or
as an additive bias to the plain einsum attention; with fast_windowed the
windowed blocks' einsum attention keeps its bias and logits in the
activation dtype, with fp32 softmax statistics only (the JAX package's fast
branch). The neck runs in fp32.
Parameters use the `blocks` layout (one dict per block) or the stacked
`block_runs` layout of `stack_for_scan` (one stacked dict per run of
windowed blocks, looped over its leading axis; the same arithmetic).

Under the GSPMD leg (`tp`, a parallel/gspmd.GspmdAxis) a rank holds its
blocks under JAX's param_pspecs: the contiguous qkv column slice is
gathered over tp and the rank's heads of q, k and v taken
(GspmdAxis.qkv_heads), so K2 and K3 run at the rank's heads with their
rel-pos terms; proj is row-parallel over those heads and fc1 / fc2 column
and row split, each sum over tp followed by its bias. In the stacked
layout JAX's rules, written for per-block paths, split a run's leaves along
their stack axis or their input rows; the rank holds those blocks, gathers
a run's split leaves over tp before the run (one run's weights at a time)
and runs its blocks whole, the single device's arithmetic.
"""
from __future__ import annotations

import math

import torch

from ..core import nn
from ..core.config import SAMEncoderConfig
from ..core.tree import leaves_with_path
from ..ops.attention import (decomposed_rel_pos_bias, get_rel_pos, merge_heads, mha,
                             split_heads, window_partition, window_unpartition)
from ..ops.flash_attention import sam_flash_attention, sam_window_attention_packed


def init(g: torch.Generator, cfg: SAMEncoderConfig, dtype=torch.float32):
    grid = cfg.grid
    params = {
        "patch_embed": nn.conv2d_init(g, 3, cfg.embed_dim,
                                      (cfg.patch_size, cfg.patch_size), dtype=dtype),
        "pos_embed": torch.zeros((1, grid, grid, cfg.embed_dim), dtype=dtype,
                                 device=g.device),
        "blocks": [],
        "neck": {
            "conv1": nn.conv2d_init(g, cfg.embed_dim, cfg.out_chans, (1, 1),
                                    bias=False, dtype=dtype),
            "ln1": nn.layer_norm_init(g, cfg.out_chans, dtype),
            "conv2": nn.conv2d_init(g, cfg.out_chans, cfg.out_chans, (3, 3),
                                    bias=False, dtype=dtype),
            "ln2": nn.layer_norm_init(g, cfg.out_chans, dtype),
        },
    }
    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        size = grid if i in cfg.global_attn_indexes else cfg.window_size
        blk = {
            "ln1": nn.layer_norm_init(g, cfg.embed_dim, dtype),
            "qkv": nn.linear_init(g, cfg.embed_dim, 3 * cfg.embed_dim, dtype=dtype),
            "proj": nn.linear_init(g, cfg.embed_dim, cfg.embed_dim, dtype=dtype),
            "ln2": nn.layer_norm_init(g, cfg.embed_dim, dtype),
            "mlp": nn.mlp_init(g, cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                               dtype=dtype),
        }
        if cfg.use_rel_pos:
            blk["rel_pos_h"] = torch.zeros((2 * size - 1, head_dim), dtype=dtype,
                                           device=g.device)
            blk["rel_pos_w"] = torch.zeros((2 * size - 1, head_dim), dtype=dtype,
                                           device=g.device)
        params["blocks"].append(blk)
    return params


def _rel_projections(q, rel_pos_h, rel_pos_w, h, w):
    """Per-axis rel-pos projections ([B,Hd,N,kh], [B,Hd,N,kw]) in q's dtype."""
    rh = get_rel_pos(h, h, rel_pos_h).to(q.dtype)
    rw = get_rel_pos(w, w, rel_pos_w).to(q.dtype)
    b, nh, _, d = q.shape
    r_q = q.reshape(b, nh, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    return rel_h.reshape(b, nh, h * w, h), rel_w.reshape(b, nh, h * w, w)


def _rel_projections_packed(q_flat, rel_pos_h, rel_pos_w, ws, num_heads):
    """Rel-pos projections from the unsplit q ([BW, T, H*D]) into K2's packed
    layout [BW, T, 2*H*ws]: lanes [h*ws:(h+1)*ws] = rel_h of head h,
    [(H+h)*ws:...] = rel_w."""
    rh = get_rel_pos(ws, ws, rel_pos_h).to(q_flat.dtype)      # [ws, ws, D]
    rw = get_rel_pos(ws, ws, rel_pos_w).to(q_flat.dtype)
    bw, t, c = q_flat.shape
    d = c // num_heads
    r_q = q_flat.reshape(bw, ws, ws, num_heads, d)
    rel_h = torch.einsum("bxynd,xkd->bxynk", r_q, rh)          # [bw,x,y,H,ws]
    rel_w = torch.einsum("bxynd,ykd->bxynk", r_q, rw)
    return torch.cat([rel_h.reshape(bw, t, num_heads * ws),
                      rel_w.reshape(bw, t, num_heads * ws)], dim=-1)


def _fast_attention(p, q, k, v, h: int, w: int) -> torch.Tensor:
    """The einsum attention's fast branch, in the JAX package's order of
    casts: rel-pos projections and their sum, the bias, in the activation
    dtype; logits (q / sqrt(D)) . k in that dtype plus the bias; p = exp of
    (logits - max) in fp32, cast back; probs = p / sum(p), the sum cast to
    the activation dtype first; out = probs . v. q, k, v: [B, H, N, D]."""
    b, nh, _, d = q.shape
    rh = get_rel_pos(h, h, p["rel_pos_h"]).to(q.dtype)
    rw = get_rel_pos(w, w, p["rel_pos_w"]).to(q.dtype)
    r_q = q.reshape(b, nh, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, h * w, h * w)
    logits = torch.einsum("bhqd,bhkd->bhqk", q / math.sqrt(d), k) + bias
    m = logits.amax(-1, keepdim=True)
    p_ = torch.exp((logits - m).float()).to(q.dtype)
    probs = p_ / p_.sum(-1, keepdim=True).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _attention(p, x: torch.Tensor, num_heads: int, use_rel_pos: bool,
               use_flash: bool, windowed: bool = False, fast: bool = False,
               tp=None) -> torch.Tensor:
    """x: [B, H, W, C] (B may include folded windows). fast: the einsum
    branch of _fast_attention where no kernel runs (rel-pos blocks). tp:
    the rank's heads of the GSPMD leg (module docstring)."""
    b, h, w, c = x.shape
    head_dim = c // num_heads
    x2 = x.reshape(b, h * w, c)
    if tp is None:
        qkv = nn.linear(p["qkv"], x2)
    else:
        qkv, num_heads = tp.qkv_heads(p["qkv"], x2, c, num_heads)
    proj = (lambda o: nn.linear(p["proj"], o)) if tp is None else \
        (lambda o: tp.row(p["proj"], o))
    cl = num_heads * head_dim
    if use_flash and use_rel_pos and windowed:
        # K2 over the packed layout: qkv stays unsplit, merged heads come back
        rel = _rel_projections_packed(qkv[:, :, :cl], p["rel_pos_h"], p["rel_pos_w"],
                                      h, num_heads)
        out = sam_window_attention_packed(qkv, rel, num_heads, head_dim, h)
        return proj(out).reshape(b, h, w, c)
    q, k, v = (split_heads(t, num_heads) for t in qkv.split(cl, dim=-1))
    if use_flash and use_rel_pos:
        rel_h, rel_w = _rel_projections(q, p["rel_pos_h"], p["rel_pos_w"], h, w)
        out = sam_flash_attention(q, k, v, rel_h.to(q.dtype), rel_w.to(q.dtype), (h, w))
    elif fast and use_rel_pos:
        out = _fast_attention(p, q, k, v, h, w)
    else:
        bias = None
        if use_rel_pos:
            bias = decomposed_rel_pos_bias(q, p["rel_pos_h"], p["rel_pos_w"],
                                           (h, w), (h, w))
        out = mha(q, k, v, bias=bias)
    return proj(merge_heads(out)).reshape(b, h, w, c)


def _block(p, x: torch.Tensor, cfg: SAMEncoderConfig, window: int,
           use_flash: bool, fast_windowed: bool = False,
           fast_gelu: bool = False, tp=None) -> torch.Tensor:
    shortcut = x
    x = nn.layer_norm(p["ln1"], x)
    if window > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
        x = _attention(p, x, cfg.num_heads, cfg.use_rel_pos, use_flash, windowed=True,
                       fast=fast_windowed, tp=tp)
        x = window_unpartition(x, window, pad_hw, (h, w))
    else:
        x = _attention(p, x, cfg.num_heads, cfg.use_rel_pos, use_flash, tp=tp)
    x = shortcut + x
    act = nn.gelu_tanh if fast_gelu else nn.gelu_exact
    h = nn.layer_norm(p["ln2"], x)
    if tp is None:
        return x + nn.mlp(p["mlp"], h, act=act)
    return x + tp.mlp(p["mlp"], h, act)


def _scan_plan(cfg: SAMEncoderConfig):
    """The block sequence as runs [(window, n), ...]: maximal runs of
    consecutive windowed blocks (window = window_size) broken by the global
    blocks (window 0, n = 1). ViT-H (global 7, 15, 23, 31): [(14, 7),
    (0, 1)] x 4."""
    plan = []
    i = 0
    while i < cfg.depth:
        if i in cfg.global_attn_indexes:
            plan.append((0, 1))
            i += 1
        else:
            j = i
            while j < cfg.depth and j not in cfg.global_attn_indexes:
                j += 1
            plan.append((cfg.window_size, j - i))
            i = j
    return plan


def _stack(group):
    """Blocks of one run -> one dict whose tensor leaves are stacked on a
    new leading axis; bool markers (the "a8" of a W8A8 projection) and None
    stay as they are."""
    first = group[0]
    if isinstance(first, dict):
        return {k: _stack([g[k] for g in group]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([g[i] for g in group]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(group)
    if any(g != first for g in group):
        raise ValueError(f"blocks of one run differ in a marker: {group}")
    return first


def _run_block(run, i: int):
    """Block i of a stacked run: each tensor leaf's slice i (a view)."""
    if isinstance(run, dict):
        return {k: _run_block(v, i) for k, v in run.items()}
    if isinstance(run, (list, tuple)):
        return type(run)(_run_block(v, i) for v in run)
    return run[i] if isinstance(run, torch.Tensor) else run


def stack_for_scan(params, cfg: SAMEncoderConfig):
    """The `block_runs` layout: "blocks" replaced by one entry per
    _scan_plan run, the plain block dict for a global block and the run's
    blocks stacked on a leading axis for a windowed run. Plain and
    quantized (ops/quant.py) block leaves stack alike. apply() loops over
    each run's leading axis, so the result equals the `blocks` layout's bit
    for bit."""
    blocks = params["blocks"]
    if len(blocks) != cfg.depth:
        raise ValueError(f"{len(blocks)} blocks for a depth of {cfg.depth}")
    out = {k: v for k, v in params.items() if k != "blocks"}
    runs, i = [], 0
    for _, n in _scan_plan(cfg):
        group = blocks[i:i + n]
        i += n
        runs.append(group[0] if n == 1 else _stack(group))
    out["block_runs"] = runs
    return out


def _blocks(params, cfg: SAMEncoderConfig, tp=None):
    """(block params, window, the block's tp) in order, from either layout.
    Under the GSPMD leg a stacked run's split leaves are gathered over tp
    first and its blocks run whole (tp None)."""
    if "block_runs" not in params:
        for i, blk in enumerate(params["blocks"]):
            yield blk, (0 if i in cfg.global_attn_indexes else cfg.window_size), tp
        return
    plan = _scan_plan(cfg)
    if len(params["block_runs"]) != len(plan):
        raise ValueError(f"stacked params were built under another config "
                         f"({len(params['block_runs'])} runs against the plan {plan})")
    for (window, n), run in zip(plan, params["block_runs"]):
        if n == 1:
            yield run, window, tp
            continue
        lead = next(x for x in leaves_with_path(run).values()
                    if isinstance(x, torch.Tensor)).shape[0]
        if lead != n:
            raise ValueError(f"a stacked run has a leading axis of {lead}, the plan {n}")
        if tp is not None:
            run = tp.whole(run)
        for i in range(n):
            yield _run_block(run, i), window, None


def apply(params, cfg: SAMEncoderConfig, images: torch.Tensor, *,
          use_flash: bool = False, fast_windowed: bool = False,
          fast_gelu: bool = False, tp=None) -> torch.Tensor:
    """images: [B, img, img, 3] NHWC (normalized, padded). Returns
    [B, grid, grid, out_chans] NHWC feature maps. fast_windowed: the
    windowed blocks' einsum attention takes its fast branch (no effect with
    use_flash, whose kernels run). tp: a rank of the GSPMD leg (module
    docstring)."""
    x = nn.conv2d(params["patch_embed"], images,
                  stride=(cfg.patch_size, cfg.patch_size), padding="VALID")
    x = x + params["pos_embed"].to(x.dtype)
    for blk, window, blk_tp in _blocks(params, cfg, tp):
        x = _block(blk, x, cfg, window, use_flash, fast_windowed, fast_gelu, blk_tp)
    # neck in fp32 (the upstream encoder's overflow guard)
    n = params["neck"]
    y = x.float()
    y = nn.conv2d({k: v.float() for k, v in n["conv1"].items()}, y, padding="VALID")
    y = nn.layer_norm2d(n["ln1"], y)
    y = nn.conv2d({k: v.float() for k, v in n["conv2"].items()}, y, padding="SAME")
    y = nn.layer_norm2d(n["ln2"], y)
    return y.to(x.dtype)
