"""The bf16 route of K2b and K10b (csrc/attention_mma_bwd.cuh with the
window problems of csrc/sam_window_attention_bwd.cu and
sam_window_attention_split_bwd.cu), emulated in plain torch on the CPU,
against K10b's plain backward, and its launch plan
(ops/flash_attention.window_bwd_plan) checked for coverage.

The kernels form s = (q * scale)_bf16 . k + (rel_h[k // ws] + rel_w[k %
ws]), as the forward forms it, and dp = g . v from bf16 operands with fp32
sums, as the TPU kernels do. p and ds are fp32, and the TPU kernels form
dv = p^T g, dk = ds^T q and dq = ds k in fp32; on the tensor cores each of
these takes its fp32 operand split as hi = bf16(x), lo = bf16(x - hi), two
bf16 products into one fp32 sum. The other operand (g, q or k) is a bf16
input, so every product is exact and only the split loses bits. drel_h and
drel_w are products of the same split ds with one-hot matrices (B[k][c] = 1
where key k lies in window row, or column, c), fp32 sums taken in the
plan's order: one step of 16 keys at a time, so a window row that a step
boundary cuts is summed in parts.

test_split_products_within_the_bf16_bounds holds each emulated gradient
(rounded to bf16, as the kernels write it) to the bounds that chip_smoke.py
holds K2b and K10b to on the card: relative to the gradient's largest
magnitude (at least 1), max 3e-2 (BF16_MAX_ABS) and mean 3e-3
(BF16_MEAN_ABS). test_split_is_ten_times_closer_than_bf16 measures, before
that rounding, the error of dv, dk and dq against the same products in
float64, and asserts that the split's is at least 10 times smaller than
that of rounding p and ds to bf16 alone. The plan tests assert that every
(query, key) pair is multiplied exactly once in each pass (the warps whose
rows all lie past T skipped), and that every key enters each query's
drel_h and drel_w sums exactly once, at its own window row and column.
"""
import math

import numpy as np
import pytest
import torch

from walkgpt_tpu_torch.ops import flash_attention as tfa

BF16_MAX_ABS, BF16_MEAN_ABS = 3e-2, 3e-3      # chip_smoke.py's bf16 bounds
# (ws, D, BW, H): T = 9, 25, 49, 196; D = 16, 20 (a padded head dim), 80
# (ViT-H's); BW * H odd
CASES = [(3, 16, 5, 3), (5, 20, 3, 3), (7, 80, 3, 1), (14, 80, 1, 3), (14, 20, 3, 1)]


def _inputs(ws, d, bw, h, seed):
    """q, k, v, rel_h, rel_w, g in bf16 [BW, H, T, *] from a numpy seed, and
    the forward's out and lse from K10's plain version."""
    rng = np.random.RandomState(seed)
    t = ws * ws
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
    q, k, v, g = (mk(bw, h, t, d) for _ in range(4))
    rel_h, rel_w = mk(bw, h, t, ws), mk(bw, h, t, ws)
    out, lse = tfa.sam_window_attention_reference(q, k, v, rel_h, rel_w, ws)
    return q, k, v, rel_h, rel_w, g, out, lse


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _kernel_scheme(q, k, v, rel_h, rel_w, g, out, lse, ws, how):
    """The gradients as the bf16 route forms them, before the rounding to
    bf16. how: "split" (hi + lo), "bf16" (p and ds rounded to bf16 alone)
    or "exact" (the same fp32 p and ds, products summed in float64)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qs = (q * torch.tensor(scale, dtype=torch.bfloat16)).float()   # q * scale, in bf16
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    key = torch.arange(q.shape[2])
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    s = s + (rel_h.float()[..., key // ws] + rel_w.float()[..., key % ws])
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (gf * out.float()).sum(-1)[..., None])

    def prod(eq, x, y):
        if how == "exact":
            return torch.einsum(eq, x.double(), y.double())
        if how == "bf16":
            return torch.einsum(eq, x.to(torch.bfloat16).float(), y)
        hi, lo = _split(x)
        return torch.einsum(eq, hi, y) + torch.einsum(eq, lo, y)

    dv = prod("bhqk,bhqd->bhkd", p, gf)
    dk = prod("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = prod("bhqk,bhkd->bhqd", ds, kf) * scale
    # drel: fp32 sums of the split ds (hi + lo is exact in fp32) in the
    # plan's order, one step of 16 keys at a time
    plan = tfa.window_bwd_plan(ws * ws, ws)
    dsr = sum(_split(ds)) if how == "split" else ds
    drel = []
    for terms in (plan["drel_h"], plan["drel_w"]):
        acc = torch.zeros(*ds.shape[:3], ws)
        for col, keys in terms:
            acc[..., col] += dsr[..., keys].sum(-1)
        drel.append(acc)
    return dq, dk, dv, *drel


@pytest.mark.parametrize("ws,d,bw,h", CASES)
def test_split_products_within_the_bf16_bounds(ws, d, bw, h):
    q, k, v, rel_h, rel_w, g, out, lse = _inputs(ws, d, bw, h, seed=ws * d + bw)
    want = tfa.sam_window_attention_bwd_reference(q, k, v, rel_h, rel_w, ws, out, lse, g)
    got = _kernel_scheme(q, k, v, rel_h, rel_w, g, out, lse, ws, "split")
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.to(w.dtype).float()
        w = w.float()
        scale = max(1.0, float(w.abs().max()))
        err = (a - w).abs()
        assert torch.isfinite(a).all()
        assert float(err.max()) <= BF16_MAX_ABS * scale, (i, float(err.max()), scale)
        assert float(err.mean()) <= BF16_MEAN_ABS * scale, (i, float(err.mean()), scale)


@pytest.mark.parametrize("ws,d,bw,h", CASES)
def test_split_is_ten_times_closer_than_bf16(ws, d, bw, h):
    q, k, v, rel_h, rel_w, g, out, lse = _inputs(ws, d, bw, h, seed=ws * d + bw + 1)
    args = (q, k, v, rel_h, rel_w, g, out, lse, ws)
    exact = _kernel_scheme(*args, "exact")
    split = _kernel_scheme(*args, "split")
    single = _kernel_scheme(*args, "bf16")
    for name, e, sp, si in zip(("dq", "dk", "dv"), exact, split, single):
        err_split = float((sp.double() - e).abs().max())
        err_single = float((si.double() - e).abs().max())
        assert err_split * 10 <= err_single, (name, err_split, err_single)


def _pair_counts(t, products):
    """How often each (row, column) pair below T is multiplied, and the
    products formed in all (padding included)."""
    count = np.zeros((t, t), np.int32)
    formed = 0
    for rows, cols in products:
        formed += len(rows) * len(cols)
        count[rows.start:min(rows.stop, t), cols.start:min(cols.stop, t)] += 1
    return count, formed


@pytest.mark.parametrize("ws", [2, 3, 5, 7, 8, 14, 16])
def test_plan_multiplies_every_pair_once(ws):
    """Each pass multiplies every (query, key) pair exactly once; the warps
    whose 16 rows all lie past T form nothing, the streamed tiles run whole."""
    t = ws * ws
    tiles = -(-t // tfa.BWD_TILE)
    count, formed = _pair_counts(t, tfa.window_bwd_plan(t, ws)["products"])
    assert (count == 1).all()
    groups = -(-t // tfa.BWD_WARP_ROWS)          # groups of 16 rows that hold a row < T
    assert formed == groups * tfa.BWD_WARP_ROWS * tiles * tfa.BWD_TILE
    if ws == 14:      # ViT-H: 13 warps of 16 rows each pass, against 4 tiles of 64 keys
        assert formed == 208 * 256


@pytest.mark.parametrize("ws", [2, 3, 5, 7, 8, 14, 16, 20, 64])
def test_plan_sums_every_key_into_its_window_row_and_column_once(ws):
    """drel_h[q, r] takes every key of window row r once, drel_w[q, c] every
    key of window column c once, across the steps (16 keys on the one-hot
    path, ws <= 16; a tile of 64 on the general path, ws = 20; a tile, one
    grid row, at ws = 64); a step cuts the window rows that straddle its
    boundary, and exactly those rows are summed in two parts."""
    t = ws * ws
    step = 16 if ws <= 16 else 64
    plan = tfa.window_bwd_plan(t, ws)
    for terms, of in ((plan["drel_h"], lambda key: key // ws),
                      (plan["drel_w"], lambda key: key % ws)):
        seen = np.zeros(t, np.int32)
        for col, keys in terms:
            assert all(of(key) == col for key in keys)
            seen[keys] += 1
        assert (seen == 1).all()
    parts = np.bincount([r for r, _ in plan["drel_h"]], minlength=ws)
    steps = [len({k // step for k in range(r * ws, (r + 1) * ws)}) for r in range(ws)]
    assert parts.tolist() == steps
    if ws == 14:      # 16-key steps cut all rows but 0, 7, 8 (keys 0-13, 98-125)
        assert [r for r in range(ws) if parts[r] == 1] == [0, 7, 8] and parts.max() == 2
