"""The product scheme of K1's bf16 route (csrc/flash_attention.cu on the
tensor-core engine of csrc/attention_mma.cuh), emulated in plain torch on
the CPU, against the JAX K1 (its Pallas kernel in interpret mode) and K1's
plain version.

The TPU kernel forms s = (q * scale) . k in fp32 from the fp32 upcast of q
and takes the fp32 p unrounded into p . v. The kernel forms q . k as one
bf16 product of the two bf16 inputs (every product exact, fp32 sums) and
multiplies the fp32 sum by scale, as K1b does; masked logits (key_valid,
or a key above the diagonal) are the finite -1e30. It walks 64-key tiles
up to the diagonal tile of its 64-query tile with an online softmax (m,
alpha = exp(m - m_new), l = l alpha + sum p), and takes the value product
with p split as hi = bf16(p), lo = bf16(p - hi), two bf16 products into
one fp32 sum, so about 16 significant bits of p are kept where bf16 alone
keeps 8. out = acc / max(l, 1e-30) in bf16, lse = m + log(l).

Rows with no valid key (row 1's first MASKED_PREFIX queries: its first
keys are invalid and the causal mask hides the rest): every logit the row
sees is -1e30, so p = 1 for each key of the tiles it visits, and out is the
mean of v over the keys below N of the 64-key tiles up to its diagonal
tile (the CUDA-core engine's output too); lse is -1e30 + log(count), which
is -1e30 in fp32. The JAX kernel visits its own 512-key blocks, which also
hold its padding keys, and the plain version all N keys, so on these rows
they average other sets: there the emulation is held to that mean, finite,
within 1e-5 (fp32 sums of bf16 values), and compared with neither.

test_scheme_matches_jax_and_the_plain_version holds, on every row with a
valid key, the emulated out (rounded to bf16, as the kernel writes it) to
the JAX kernel and to the plain version within chip_smoke.py's bf16 bounds
(max 3e-2, mean 3e-3) and lse within 1e-2.
test_split_is_ten_times_closer_than_bf16 measures, before that rounding,
the error of out against the same p with the products summed in float64,
and asserts that the split's is at least 10 times smaller than that of p
rounded to bf16 alone.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu_torch.ops import flash_attention as tfa

BF16_MAX_ABS, BF16_MEAN_ABS = 3e-2, 3e-3      # chip_smoke.py's bf16 bounds
LSE_ABS = 1e-2
TILE = 64                                      # the engine's query and key tiles
MASKED_PREFIX = 5                              # row 1's first keys: invalid
CASES = [(37, 80), (37, 128), (70, 80), (70, 128)]


def _inputs(n, d, seed):
    """q, k, v in bf16 ([2, 2, N, D]) from a numpy seed; key_valid [2, N]:
    row 0 all valid, row 1 without its first MASKED_PREFIX keys and its
    last 7 (padding), so that under the causal mask its queries 0 .. 4 see
    no key."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (mk(2, 2, n, d) for _ in range(3))
    pos = torch.arange(n)
    kv = torch.stack([pos < n, (pos >= MASKED_PREFIX) & (pos < n - 7)])
    return q, k, v, kv


def _mask(n, kv):
    pos = torch.arange(n)
    return kv[:, None, None, :] & (pos[None, :] <= pos[:, None])[None, None]


def _kernel_scheme(q, k, v, kv, how):
    """(out, lse) as K1's bf16 route forms them, out before its rounding to
    bf16. how: "split" (p as hi + lo), "bf16" (p rounded to bf16 alone) or
    "exact" (the same fp32 p, the value products summed in float64)."""
    b, h, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s_all = torch.where(_mask(n, kv), s_all, -1e30)
    vf = v.float()
    acc_type = torch.float64 if how == "exact" else torch.float32
    out = torch.zeros((b, h, n, d), dtype=acc_type)
    lse = torch.zeros((b, h, n))
    for q0 in range(0, n, TILE):
        rows = slice(q0, min(q0 + TILE, n))
        nr = rows.stop - q0
        m = torch.full((b, h, nr), -1e30)
        l = torch.zeros((b, h, nr))
        acc = torch.zeros((b, h, nr, d), dtype=acc_type)
        for k0 in range(0, q0 + TILE, TILE):        # up to the diagonal tile
            keys = slice(k0, min(k0 + TILE, n))
            s = s_all[:, :, rows, keys]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            if how == "exact":
                pv = torch.einsum("bhqk,bhkd->bhqd", p.double(), vf[:, :, keys].double())
            else:
                hi = p.to(torch.bfloat16).float()
                pv = torch.einsum("bhqk,bhkd->bhqd", hi, vf[:, :, keys])
                if how == "split":
                    lo = (p - hi).to(torch.bfloat16).float()
                    pv = pv + torch.einsum("bhqk,bhkd->bhqd", lo, vf[:, :, keys])
            acc = acc * alpha[..., None].to(acc_type) + pv
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None].to(acc_type)
        lse[:, :, rows] = m + torch.log(l.clamp_min(1e-30))
    return out, lse


def _no_valid_key(n, kv):
    """[B, N] bool: the query rows that see no valid key."""
    return ~_mask(n, kv)[:, 0].any(-1)


@pytest.mark.parametrize("n,d", CASES)
def test_scheme_matches_jax_and_the_plain_version(n, d):
    q, k, v, kv = _inputs(n, d, seed=n * d)
    got, got_lse = _kernel_scheme(q, k, v, kv, "split")
    got_bf16 = got.to(torch.bfloat16).float()
    want, want_lse = jfa._flash_attention_impl(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), jnp.asarray(k.float().numpy(), jnp.bfloat16),
        jnp.asarray(v.float().numpy(), jnp.bfloat16), True, jfa.DEFAULT_BQ, jfa.DEFAULT_BK,
        jnp.asarray(kv.numpy()), return_lse=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(want_lse))
    plain, plain_lse = tfa.flash_attention_reference(q, k, v, True, kv)
    dead = _no_valid_key(n, kv)
    assert int(dead.sum()) == MASKED_PREFIX and bool(dead[1, :MASKED_PREFIX].all())
    live = ~dead[:, None, :].expand(-1, q.shape[1], -1)
    for ref, ref_lse in ((want, want_lse), (plain.float(), plain_lse)):
        err = (got_bf16 - ref)[live].abs()
        assert float(err.max()) <= BF16_MAX_ABS, float(err.max())
        assert float(err.mean()) <= BF16_MEAN_ABS, float(err.mean())
        assert float((got_lse - ref_lse)[live].abs().max()) <= LSE_ABS
    # rows with no valid key: the mean of v over the keys of the tiles they visit
    for r in range(MASKED_PREFIX):
        visited = min(n, (r // TILE + 1) * TILE)
        mean = v[1, :, :visited].float().mean(1)
        assert torch.isfinite(got[1, :, r]).all()
        torch.testing.assert_close(got[1, :, r].float(), mean, atol=1e-5, rtol=1e-5)
        assert bool((got_lse[1, :, r] <= -1e29).all())


@pytest.mark.parametrize("n,d", CASES)
def test_split_is_ten_times_closer_than_bf16(n, d):
    args = _inputs(n, d, seed=n * d + 1)
    exact = _kernel_scheme(*args, "exact")[0]
    split = _kernel_scheme(*args, "split")[0]
    single = _kernel_scheme(*args, "bf16")[0]
    err_split = float((split.double() - exact).abs().max())
    err_single = float((single.double() - exact).abs().max())
    assert err_split * 10 <= err_single, (err_split, err_single)
