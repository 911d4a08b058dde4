"""The plain versions of the three main-path attention kernels (K1-K3)
against the JAX Pallas kernels, which run in interpret mode on the CPU.

Tolerance: fp32 inputs, atol = rtol = 1e-5. Both sides compute the same
fp32 softmax; they differ only in summation order (the Pallas kernels tile
and use an online softmax), which moves results by a few ulp of values of
order one. The CUDA kernels themselves run only on the card (chip_smoke.py,
tests/test_torch_kernels_gpu.py), where they are held against these plain
versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("n,d,causal", [(37, 16, True), (70, 20, True), (29, 20, False)])
def test_k1_flash_attention_plain_matches_pallas(n, d, causal):
    rng = np.random.RandomState(n + d)
    b, h = 2, 3
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    lengths = np.array([n, n - 11])
    key_valid = np.arange(n)[None] < lengths[:, None]           # right padding
    want, want_lse = jfa._flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, jfa.DEFAULT_BQ,
        jfa.DEFAULT_BK, jnp.asarray(key_valid), return_lse=True)
    got, got_lse = tfa.flash_attention(_t(q), _t(k), _t(v), causal, _t(key_valid),
                                       return_lse=True)
    # every row has a valid key (key 0), so every row is compared
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("ws,d,h", [(2, 16, 2), (3, 20, 3)])
def test_k2_window_attention_plain_matches_pallas(ws, d, h):
    rng = np.random.RandomState(ws * d)
    bw, t = 5, ws * ws
    qkv = rng.randn(bw, t, 3 * h * d).astype(np.float32)
    rel = rng.randn(bw, t, 2 * h * ws).astype(np.float32)
    want, want_lse = jfa._win_packed_impl(jnp.asarray(qkv), jnp.asarray(rel), h, d, ws)
    got, got_lse = tfa.sam_window_attention_packed(_t(qkv), _t(rel), h, d, ws,
                                                   return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("gh,gw,d", [(4, 4, 16), (5, 7, 20)])
def test_k3_sam_flash_attention_plain_matches_pallas(gh, gw, d):
    rng = np.random.RandomState(gh * gw + d)
    b, h, n = 2, 2, gh * gw
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    rel_h = rng.randn(b, h, n, gh).astype(np.float32)
    rel_w = rng.randn(b, h, n, gw).astype(np.float32)
    want, want_lse = jfa._sam_flash_impl(
        *(jnp.asarray(x) for x in (q, k, v, rel_h, rel_w)), (gh, gw),
        jfa.DEFAULT_BQ, jfa.DEFAULT_BK, return_lse=True)
    got, got_lse = tfa.sam_flash_attention(*(_t(x) for x in (q, k, v, rel_h, rel_w)),
                                           (gh, gw), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    before = [f.launches for f in tfa.KERNELS]
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 2, 9, 16).astype(np.float32))
    out = tfa.flash_attention(q, q, q, True, None)
    ref, _ = tfa.flash_attention_reference(q, q, q, True, None)
    assert torch.equal(out, ref)
    tfa.sam_window_attention_packed(torch.zeros(2, 4, 3 * 32), torch.zeros(2, 4, 8), 2, 16, 2)
    tfa.sam_flash_attention(q, q, q, torch.zeros(1, 2, 9, 3), torch.zeros(1, 2, 9, 3), (3, 3))
    assert [f.launches for f in tfa.KERNELS] == before


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def test_bf16_rounding_points_match_pallas():
    """In bf16 the plain versions round where the Pallas kernels round (K1:
    fp32 math after the upcast; K2/K3: q*scale and p in bf16). Outputs are
    bf16, so they may differ by one bf16 rounding step of the output (2^-8
    relative) where the fp32 sums, taken in another order, straddle a
    rounding boundary."""
    rng = np.random.RandomState(2)
    one_ulp = lambda got, want: np.testing.assert_array_less(
        np.abs(got.float().numpy() - np.asarray(want, np.float32)),
        2.0 ** -8 * np.abs(np.asarray(want, np.float32)) + 1e-6)
    q, k, v = (rng.randn(2, 2, 21, 16).astype(np.float32) for _ in range(3))
    kv = np.arange(21)[None] < np.array([[21], [15]])
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    one_ulp(tfa.flash_attention(qt, kt, vt, True, torch.from_numpy(kv)),
            jfa.flash_attention(qj, kj, vj, True, key_valid=jnp.asarray(kv)))
    rh = rng.randn(2, 2, 21, 3).astype(np.float32)
    rw = rng.randn(2, 2, 21, 7).astype(np.float32)
    (rhj, rht), (rwj, rwt) = _bf16(rh), _bf16(rw)
    one_ulp(tfa.sam_flash_attention(qt, kt, vt, rht, rwt, (3, 7)),
            jfa.sam_flash_attention(qj, kj, vj, rhj, rwj, (3, 7)))
    qkv = rng.randn(3, 9, 3 * 2 * 16).astype(np.float32)
    rel = rng.randn(3, 9, 2 * 2 * 3).astype(np.float32)
    (qkvj, qkvt), (relj, relt) = _bf16(qkv), _bf16(rel)
    one_ulp(tfa.sam_window_attention_packed(qkvt, relt, 2, 16, 3),
            jfa.sam_window_attention_packed(qkvj, relj, 2, 16, 3))
