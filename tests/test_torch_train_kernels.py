"""The backward kernels' plain versions (K1b, K2b, K3b), reached through the
torch.autograd.Function of each attention kernel on CPU tensors, against
jax.vjp of the JAX kernels, whose custom_vjp backwards run their Pallas
kernels in interpret mode on the CPU. Then one gradient of the whole tiny
SAM encoder (K2 and K3 blocks) with respect to its parameters, against
jax.grad of the JAX encoder.

Tolerances. fp32: atol = rtol = 1e-5; both sides compute the same fp32
products and differ only in summation order (the Pallas kernels tile the
keys and queries). bf16: both sides round q*scale (K2/K3) and the outputs
at the same points, so a gradient differs by at most one bf16 rounding
step of its value: |got - want| <= 2^-7 |want| + 1e-5. The encoder's
parameter gradients sum over every token of both images through two
blocks and the neck: atol = rtol = 1e-4 in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import SAM_VIT_TINY as J_SAM_VIT_TINY
from walkgpt_tpu.models import sam_encoder as jenc
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu_torch.core.config import SAM_VIT_TINY
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.models import sam_encoder as tenc
from walkgpt_tpu_torch.ops import flash_attention as tfa

FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(rng, dtype, *shapes):
    """The same random values as numpy fp32 (rounded to dtype) for JAX and
    as torch tensors that require gradients."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays])


def _compare(got, want, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, **FP32_TOL, err_msg=f"gradient {i}")
        else:
            np.testing.assert_array_less(np.abs(g - w), 2.0 ** -7 * np.abs(w) + 1e-5,
                                         err_msg=f"gradient {i}")


def _vjp_both(jfn, tfn, jx, tx, go):
    """(port gradients through autograd, JAX gradients through jax.vjp) of
    the output cotangent go (numpy)."""
    jout, pull = jax.vjp(jfn, *jx)
    want = pull(jnp.asarray(go, jout.dtype))
    tout = tfn(*tx)
    got = torch.autograd.grad(tout, tx, torch.from_numpy(go).to(tout.dtype))
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,causal,masked_prefix", [
    (37, 16, True, 0),       # causal with key padding, N not a multiple of the tile
    (70, 80, True, 5),       # D = 80; keys 0-4 of row 1 invalid: queries 0-4 fully masked
    (29, 20, False, 0)])     # non-causal
def test_k1b_plain_matches_jax_vjp(dtype, n, d, causal, masked_prefix):
    rng = np.random.RandomState(n + d)
    b, h = 2, 3
    jx, tx = _inputs(rng, dtype, *[(b, h, n, d)] * 3)
    pos = np.arange(n)
    kv = np.stack([pos < n, (pos >= masked_prefix) & (pos < n - 11)])
    go = rng.randn(b, h, n, d).astype(np.float32)
    got, want = _vjp_both(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal, key_valid=jnp.asarray(kv)),
        lambda q, k, v: tfa.flash_attention(q, k, v, causal, torch.from_numpy(kv)),
        jx, tx, go)
    _compare(got, want, dtype)
    if masked_prefix:
        assert not got[0][1, :, :masked_prefix].any()      # no gradient for masked rows


def test_k1b_fully_masked_batch_row_is_bounded():
    """A batch row whose keys are all invalid (tests/test_flash_attention.py:
    273): p is exactly 0, so the row gets no gradient at all, as in JAX."""
    rng = np.random.RandomState(80)
    jx, tx = _inputs(rng, torch.float32, *[(2, 1, 32, 8)] * 3)
    kv = np.ones((2, 32), bool)
    kv[1] = False
    go = rng.randn(2, 1, 32, 8).astype(np.float32)
    got, want = _vjp_both(
        lambda q, k, v: jfa.flash_attention(q, k, v, False, 16, 16, key_valid=jnp.asarray(kv)),
        lambda q, k, v: tfa.flash_attention(q, k, v, False, torch.from_numpy(kv)),
        jx, tx, go)
    _compare(got, want, torch.float32)
    assert all(not g[1].any() for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,d,h", [(2, 16, 2), (3, 20, 3), (3, 80, 1)])
def test_k2b_plain_matches_jax_vjp(dtype, ws, d, h):
    rng = np.random.RandomState(ws * d + h)
    bw, t = 5, ws * ws
    jx, tx = _inputs(rng, dtype, (bw, t, 3 * h * d), (bw, t, 2 * h * ws))
    go = rng.randn(bw, t, h * d).astype(np.float32)
    got, want = _vjp_both(lambda qkv, rel: jfa.sam_window_attention_packed(qkv, rel, h, d, ws),
                          lambda qkv, rel: tfa.sam_window_attention_packed(qkv, rel, h, d, ws),
                          jx, tx, go)
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,d", [(4, 4, 16), (5, 7, 20), (3, 5, 80)])
def test_k3b_plain_matches_jax_vjp(dtype, gh, gw, d):
    rng = np.random.RandomState(gh * gw + d)
    b, h, n = 2, 2, gh * gw
    jx, tx = _inputs(rng, dtype, *[(b, h, n, d)] * 3, (b, h, n, gh), (b, h, n, gw))
    go = rng.randn(b, h, n, d).astype(np.float32)
    got, want = _vjp_both(lambda *x: jfa.sam_flash_attention(*x, (gh, gw)),
                          lambda *x: tfa.sam_flash_attention(*x, (gh, gw)), jx, tx, go)
    _compare(got, want, dtype)


def test_sam_encoder_param_grads_match_jax():
    """d(sum of the encoder's features)/d(parameters) through the flash path:
    the window blocks' K2b and the global block's K3b (plain versions)
    against jax.grad of the JAX encoder (Pallas in interpret mode)."""
    params = jax.device_get(jenc.init(jax.random.PRNGKey(2), J_SAM_VIT_TINY))
    rng = np.random.RandomState(70)
    for blk in params["blocks"]:
        blk["rel_pos_h"] = (0.3 * rng.randn(*blk["rel_pos_h"].shape)).astype(np.float32)
        blk["rel_pos_w"] = (0.3 * rng.randn(*blk["rel_pos_w"].shape)).astype(np.float32)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jenc.apply(p, J_SAM_VIT_TINY, jnp.asarray(x),
                                                 use_flash=True).sum()))(params)
    tp = from_numpy_tree(params, "cpu")
    leaves = leaves_with_path(tp)
    for t in leaves.values():
        t.requires_grad_()
    before = [f.launches for f in tfa.KERNELS]
    tenc.apply(tp, SAM_VIT_TINY, torch.from_numpy(x), use_flash=True).sum().backward()
    assert [f.launches for f in tfa.KERNELS] == before       # plain versions on the CPU
    want = {p: np.asarray(v) for p, v in leaves_with_path(jax.device_get(want)).items()}
    assert want.keys() == leaves.keys()
    for p, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[p], atol=1e-4, rtol=1e-4, err_msg=p)
