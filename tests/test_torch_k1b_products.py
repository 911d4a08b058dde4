"""The product scheme of K1b's bf16 route (csrc/flash_attention_bwd.cu on the
pair layout of csrc/attention_mma_bwd.cuh), emulated in plain torch on the
CPU, against K1b's plain backward.

The TPU kernels form s = (q * scale) . k in fp32 from the fp32 upcast of q.
The kernel forms q . k as one bf16 product of the two bf16 inputs (every
product exact, fp32 sums) and multiplies the fp32 sum by scale; dp = g . v
likewise as one product. p = exp(s - lse) is exactly 0 where the causal
mask or key_valid masks the pair, so a fully masked row gets no gradient.
p and ds are fp32, and the TPU kernels form dv = p^T g, dk = ds^T q and dq
= ds k in fp32; on the tensor cores each of these takes its fp32 operand
split as hi = bf16(x), lo = bf16(x - hi), two bf16 products into one fp32
sum, so about 16 significant bits of p and ds are kept where bf16 alone
keeps 8. dq and dk are scaled at the end.

test_split_products_within_the_bf16_bounds holds each emulated gradient
(rounded to bf16, as the kernel writes it) to the bounds that chip_smoke.py
holds K1b to on the card: relative to the gradient's largest magnitude (at
least 1), max 3e-2 (BF16_MAX_ABS) and mean 3e-3 (BF16_MEAN_ABS); the fully
masked rows' dq is exactly 0. test_split_is_ten_times_closer_than_bf16
measures, before that rounding, the error of dv, dk and dq against the same
products in float64, and asserts that the split's is at least 10 times
smaller than that of rounding p and ds to bf16 alone.
test_scaled_accumulator_is_closer_than_a_split_q holds the logits to the
TPU's fp32 (q * scale) . k: scale times the fp32 sum of exact products lies
at least 10 times closer (mean error) than two bf16 products of q * scale
split in hi and lo would.
"""
import math

import numpy as np
import pytest
import torch

from walkgpt_tpu_torch.ops import flash_attention as tfa

BF16_MAX_ABS, BF16_MEAN_ABS = 3e-2, 3e-3      # chip_smoke.py's bf16 bounds
MASKED_PREFIX = 5                              # row 1's first keys: invalid
# (N, D): N not a multiple of 64 (a ragged last tile on both sides), the
# LLM's head dim 128 and SAM's 80
CASES = [(70, 128), (37, 128), (70, 80), (37, 80)]


def _inputs(n, d, seed):
    """q, k, v, g in bf16 ([2, 2, N, D]) from a numpy seed; key_valid [2,
    N]: row 0 all valid, row 1 without its first MASKED_PREFIX keys and its
    last 7, so that under the causal mask its queries 0 .. 4 see no key
    (fully masked rows); the forward's out and lse from K1's plain version."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
    q, k, v, g = (mk(2, 2, n, d) for _ in range(4))
    pos = torch.arange(n)
    kv = torch.stack([pos < n, (pos >= MASKED_PREFIX) & (pos < n - 7)])
    out, lse = tfa.flash_attention_reference(q, k, v, True, kv)
    return q, k, v, g, kv, out, lse


def _mask(n, kv):
    pos = torch.arange(n)
    return kv[:, None, None, :] & (pos[None, :] <= pos[:, None])[None, None]


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _kernel_scheme(q, k, v, g, kv, out, lse, how):
    """The gradients as K1b's bf16 route forms them, before the rounding to
    bf16. how: "split" (hi + lo), "bf16" (p and ds rounded to bf16 alone) or
    "exact" (the same fp32 p and ds, products summed in float64)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale     # exact products, fp32 sums
    p = torch.where(_mask(q.shape[2], kv), torch.exp(s - lse[..., None]), 0.0)
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
    return dq, dk, dv


@pytest.mark.parametrize("n,d", CASES)
def test_split_products_within_the_bf16_bounds(n, d):
    q, k, v, g, kv, out, lse = _inputs(n, d, seed=n * d)
    want = tfa.flash_attention_bwd_reference(q, k, v, True, kv, out, lse, g)
    got = _kernel_scheme(q, k, v, g, kv, out, lse, "split")
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.to(w.dtype).float()
        w = w.float()
        scale = max(1.0, float(w.abs().max()))
        err = (a - w).abs()
        assert torch.isfinite(a).all()
        assert float(err.max()) <= BF16_MAX_ABS * scale, (i, float(err.max()), scale)
        assert float(err.mean()) <= BF16_MEAN_ABS * scale, (i, float(err.mean()), scale)
    # the fully masked rows (row 1, queries 0 .. 4) get exactly no gradient
    assert not got[0][1, :, :MASKED_PREFIX].any()
    assert not want[0][1, :, :MASKED_PREFIX].any()


@pytest.mark.parametrize("n,d", CASES)
def test_split_is_ten_times_closer_than_bf16(n, d):
    args = _inputs(n, d, seed=n * d + 1)
    exact = _kernel_scheme(*args, "exact")
    split = _kernel_scheme(*args, "split")
    single = _kernel_scheme(*args, "bf16")
    for name, e, sp, si in zip(("dq", "dk", "dv"), exact, split, single):
        err_split = float((sp.double() - e).abs().max())
        err_single = float((si.double() - e).abs().max())
        assert err_split * 10 <= err_single, (name, err_split, err_single)


@pytest.mark.parametrize("n,d", CASES)
def test_scaled_accumulator_is_closer_than_a_split_q(n, d):
    q, k = _inputs(n, d, seed=n * d + 2)[:2]
    scale = 1.0 / math.sqrt(d)
    qf, kf = q.float(), k.float()
    tpu = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)             # fp32, as the TPU
    acc = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale             # the kernel's s
    hi, lo = _split(qf * scale)
    split = torch.einsum("bhqd,bhkd->bhqk", hi, kf) + torch.einsum("bhqd,bhkd->bhqk", lo, kf)
    err_acc = float((acc - tpu).abs().mean())
    err_split = float((split - tpu).abs().mean())
    assert err_acc * 10 <= err_split, (err_acc, err_split)
