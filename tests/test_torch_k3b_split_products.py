"""The product scheme of K3b's bf16 route (csrc/attention_mma_bwd.cuh),
emulated in plain torch on the CPU, against K3b's plain backward.

The kernel forms s = (q * scale)_bf16 . k and dp = g . v from bf16 operands
with fp32 sums, as the TPU kernels do. p and ds are fp32, and the TPU
kernels form dv = p^T g, dk = ds^T q and dq = ds k in fp32; on the tensor
cores each of these takes its fp32 operand split as hi = bf16(x), lo =
bf16(x - hi), two bf16 products into one fp32 sum. The other operand (g, q
or k) is a bf16 input, so every product is exact and only the split loses
bits: about 16 significant bits of p and ds are kept where bf16 alone
keeps 8.

test_split_products_within_the_bf16_bounds holds each emulated gradient
(rounded to bf16, as the kernel writes it) to the bounds that chip_smoke.py
holds K3b to on the card: relative to the gradient's largest magnitude (at
least 1), max 3e-2 (BF16_MAX_ABS) and mean 3e-3 (BF16_MEAN_ABS).
test_split_is_ten_times_closer_than_bf16 measures, before that rounding,
the error of dv, dk and dq against the same products in float64, and asserts
that the split's is at least 10 times smaller than that of rounding p and ds
to bf16 alone.
"""
import math

import numpy as np
import pytest
import torch

from walkgpt_tpu_torch.ops import flash_attention as tfa

BF16_MAX_ABS, BF16_MEAN_ABS = 3e-2, 3e-3      # chip_smoke.py's bf16 bounds
CASES = [(8, 8, 20), (8, 8, 80), (5, 7, 20), (5, 7, 80)]


def _inputs(gh, gw, d, seed):
    """q, k, v, rel_h, rel_w, g in bf16 (2 heads, one image) from a numpy
    seed, and the forward's out and lse from K3's plain version."""
    rng = np.random.RandomState(seed)
    n, h = gh * gw, 2
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
    q, k, v, g = (mk(1, h, n, d) for _ in range(4))
    rel_h, rel_w = mk(1, h, n, gh), mk(1, h, n, gw)
    out, lse = tfa.sam_flash_attention_reference(q, k, v, rel_h, rel_w, (gh, gw))
    return q, k, v, rel_h, rel_w, g, out, lse


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _kernel_scheme(q, k, v, rel_h, rel_w, g, out, lse, grid_hw, how):
    """The gradients as K3b's bf16 route forms them, before the rounding to
    bf16. how: "split" (hi + lo), "bf16" (p and ds rounded to bf16 alone) or
    "exact" (the same fp32 p and ds, products summed in float64)."""
    gh, gw = grid_hw
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qs = (q * torch.tensor(scale, dtype=torch.bfloat16)).float()   # q * scale, in bf16
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    key = torch.arange(q.shape[2])
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    s = (s + rel_w.float()[..., key % gw]) + rel_h.float()[..., key // gw]
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
    ds5 = ds.reshape(*ds.shape[:3], gh, gw)
    return dq, dk, dv, ds5.sum(-1), ds5.sum(-2)


@pytest.mark.parametrize("gh,gw,d", CASES)
def test_split_products_within_the_bf16_bounds(gh, gw, d):
    q, k, v, rel_h, rel_w, g, out, lse = _inputs(gh, gw, d, seed=gh * gw + d)
    want = tfa.sam_flash_attention_bwd_reference(q, k, v, rel_h, rel_w, (gh, gw), out, lse, g)
    got = _kernel_scheme(q, k, v, rel_h, rel_w, g, out, lse, (gh, gw), "split")
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.to(w.dtype).float()
        w = w.float()
        scale = max(1.0, float(w.abs().max()))
        err = (a - w).abs()
        assert torch.isfinite(a).all()
        assert float(err.max()) <= BF16_MAX_ABS * scale, (i, float(err.max()), scale)
        assert float(err.mean()) <= BF16_MEAN_ABS * scale, (i, float(err.mean()), scale)


@pytest.mark.parametrize("gh,gw,d", CASES)
def test_split_is_ten_times_closer_than_bf16(gh, gw, d):
    q, k, v, rel_h, rel_w, g, out, lse = _inputs(gh, gw, d, seed=gh * gw + d + 1)
    args = (q, k, v, rel_h, rel_w, g, out, lse, (gh, gw))
    exact = _kernel_scheme(*args, "exact")
    split = _kernel_scheme(*args, "split")
    single = _kernel_scheme(*args, "bf16")
    for name, e, sp, si in zip(("dq", "dk", "dv"), exact, split, single):
        err_split = float((sp.double() - e).abs().max())
        err_single = float((si.double() - e).abs().max())
        assert err_split * 10 <= err_single, (name, err_split, err_single)
