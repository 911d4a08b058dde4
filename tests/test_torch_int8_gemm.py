"""K13a (quantize_tokens) and K13b (w8a8_gemm), the port's plain versions on
CPU tensors, against the JAX package on the CPU.

- Codes and scales: bit-exact against JAX's XLA quantize (the core/nn
  "a8" decisions, as tests/test_int8_gemm.py's _xla_w8a8 builds them) in
  fp32 and bf16, and the port's nn.linear a8 branch computes its output
  from exactly these codes.
- Against JAX's Pallas kernels in interpret mode, on the same numpy
  inputs: fp32 within JAX's own tolerance (rtol 1e-6, atol 1e-6: the same
  codes and epilogue order; erf / tanh and the products' last place may
  differ between the two libraries). bf16: interpret mode stores bf16 refs
  as f32 and skips the rounding of x * inv to bf16 that the hardware, XLA
  and the port perform (walkgpt_tpu/ops/int8_gemm.py:142-149), so at a
  round-half tie a code may differ by one: compared as tests/test_int8_gemm.py
  compares them, dequantized codes within 1.01 quant steps of x, and GEMM
  outputs within 2.5% of the row's largest magnitude (+1e-3).
- gelu_exact in fp32 takes atol 1e-6 of the output's largest magnitude:
  XLA's f32 erf does not reach -1 in the far negative tail (see the test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.ops import int8_gemm as jg
from walkgpt_tpu_torch.core import nn as tnn
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.ops import int8_gemm as tg


def _mk(m, k, n, dtype, seed=0):
    """x [m, k] in dtype, w_q [k, n] int8, w_scale [n], bias [n], as numpy."""
    rng = np.random.RandomState(seed)
    x = np.asarray(jnp.asarray(rng.randn(m, k), dtype))
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.rand(n) * 0.01 + 1e-3).astype(np.float32)
    b = (rng.randn(n) * 0.1).astype(np.float32)
    return x, wq, ws, b


def _xla_quant(x):
    """JAX's XLA quantize (core/nn.linear's a8 decisions)."""
    x = jnp.asarray(x)
    ax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    inv = (127.0 / jnp.maximum(ax.astype(jnp.float32), 1e-8)).astype(x.dtype)
    xq = jnp.clip(jnp.round(x * inv), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(1.0 / inv.astype(jnp.float32))


def _t(a):
    return from_numpy_tree(a, "cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m", [1, 37, 300])
def test_quantize_tokens_codes_bit_exact_against_xla(dtype, m):
    x, wq, ws, _ = _mk(m, 256, 64, dtype, seed=m)
    xq, sx = tg.quantize_tokens(_t(x))
    want_q, want_s = _xla_quant(x)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and tuple(sx.shape) == (m, 1)
    np.testing.assert_array_equal(xq.numpy(), want_q)
    np.testing.assert_array_equal(sx.numpy(), want_s)
    assert tg.quantize_tokens.launches == 0                  # CPU tensors: the plain version
    # the port's nn.linear a8 branch computes its output from these codes
    p = {"w_q": _t(wq), "w_scale": _t(ws), "a8": True}
    y = (xq.int() @ p["w_q"].int()).float() * sx * p["w_scale"]
    torch.testing.assert_close(tnn.linear(p, _t(x)), y.to(_t(x).dtype), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_tokens_matches_jax_kernel_with_lead_dims(dtype):
    x, _, _, _ = _mk(3 * 43, 384, 1, dtype, seed=7)
    x3 = x.reshape(3, 43, 384)                               # 129 rows: not a multiple of 8
    jq, js = jg.quantize_tokens(jnp.asarray(x3))
    xq, sx = tg.quantize_tokens(_t(x3))
    assert tuple(xq.shape) == (3, 43, 384) and tuple(sx.shape) == (3, 43, 1)
    if dtype == jnp.float32:
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(sx.numpy(), np.asarray(js), rtol=3e-7)
    else:
        xf = np.asarray(x3, np.float32)
        step = np.abs(xf).max(-1, keepdims=True) / 127.0
        for q, s in ((xq.numpy(), sx.numpy()), (np.asarray(jq), np.asarray(js))):
            assert np.all(np.abs(q.astype(np.float32) * s - xf) <= step * 1.01 + 1e-6)
        assert np.mean(xq.numpy() != np.asarray(jq)) < 0.2


@pytest.mark.parametrize("act", [None, "gelu_exact", "gelu_tanh"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_w8a8_gemm_matches_jax_kernel(act, bias, dtype):
    x, wq, ws, b = _mk(37, 256, 384, dtype, seed=11)         # 37 rows: ragged
    want = np.asarray(jg.w8a8_gemm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
                                   jnp.asarray(b) if bias else None, act=act), np.float32)
    got = tg.w8a8_gemm(_t(x), _t(wq), _t(ws), _t(b) if bias else None, act=act)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (37, 384)
    got = got.float().numpy()
    if dtype == jnp.float32:
        # XLA's f32 erf stops at -1 + 2^-24 in the far negative tail, where
        # torch's reaches -1: gelu_exact of y << 0 is then 0 here and
        # y * 2^-25 there, a difference below 1e-6 of the output's scale
        atol = 1e-6 * np.abs(want).max() if act == "gelu_exact" else 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    else:
        row = np.max(np.abs(want), axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 0.025 * row + 1e-3)


def test_w8a8_gemm_lead_dims_and_epilogue_order():
    x, wq, ws, b = _mk(2 * 21, 128, 256, jnp.float32, seed=5)
    x3 = _t(x.reshape(2, 21, 128))
    got = tg.w8a8_gemm(x3, _t(wq), _t(ws), _t(b), act="gelu_exact")
    assert tuple(got.shape) == (2, 21, 256)
    flat = tg.w8a8_gemm(_t(x), _t(wq), _t(ws), _t(b), act="gelu_exact")
    torch.testing.assert_close(got.reshape(-1, 256), flat, rtol=0, atol=0)
    # the bias is added in fp32 before the cast (nn.linear adds it after, in
    # x's dtype): in bf16 the two differ, and K13b's is the fp32 sum rounded once
    xb = _t(x).to(torch.bfloat16)
    y = tg.w8a8_gemm(xb, _t(wq), _t(ws), _t(b))
    xq, sx = tnn.quantize_a8(xb)
    want = ((xq.int() @ _t(wq).int()).float() * sx * _t(ws) + _t(b)).to(torch.bfloat16)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tg.w8a8_gemm(_t(x), _t(wq), _t(ws), act="relu")
