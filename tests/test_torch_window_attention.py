"""K10 (sam_window_attention, split-head windowed attention with the
decomposed rel-pos bias) and its backward K10b: the plain versions against
the JAX Pallas kernels in interpret mode, the port's torch.autograd.Function
on CPU tensors, and K10 against K2 (the packed layout) on repacked values.

Tolerances are the JAX package's own for these kernels
(tests/test_flash_attention.py:199-241): fp32 forward rtol = atol = 2e-5;
gradients rtol 2e-4 / atol 2e-5. Both sides compute the same fp32 products
and differ only in summation order (the Pallas kernel takes the bias through
two one-hot expansion matmuls, the plain version by indexing). The bf16
case (q, k, v in bf16, rel tables in fp32, which JAX takes too) rounds
q*scale and p at the same points on both sides, so it differs by at most
one bf16 rounding step of each output: 2^-7 |want| + 1e-5. K2's plain
versions are K10's on the heads split out of the packed layout, so on
repacked values the two agree bit for bit. The CUDA kernels run only on
the card (tests/test_torch_kernels_gpu.py, chip_smoke.py phase 2f)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)

# (bw, h, ws, d): the JAX tests' forward and backward shapes, a ragged one
# (T = 25, D = 20, BW*H odd) and ViT-H's head dim at a small window
CASES = [(3, 2, 4, 16), (2, 2, 3, 8), (3, 1, 5, 20), (1, 3, 3, 80)]


def _inputs(bw, h, ws, d, seed, dtype=torch.float32):
    """q, k, v [BW, H, T, D], rel_h, rel_w [BW, H, T, ws] fp32, the output
    cotangent g; numpy fp32, q/k/v/g rounded to dtype."""
    rng = np.random.RandomState(seed)
    t = ws * ws
    qkvg = [rng.randn(bw, h, t, d).astype(np.float32) for _ in range(4)]
    if dtype == torch.bfloat16:
        qkvg = [torch.from_numpy(a).bfloat16().float().numpy() for a in qkvg]
    rel = [rng.randn(bw, h, t, ws).astype(np.float32) for _ in range(2)]
    return qkvg[:3] + rel, qkvg[3]


def _jax(arrays, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return [jnp.asarray(a, jd) for a in arrays[:3]] + [jnp.asarray(a) for a in arrays[3:]]


def _torch(arrays, dtype, grad=False):
    return ([torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in arrays[:3]]
            + [torch.from_numpy(a).requires_grad_(grad) for a in arrays[3:]])


def _close(got, want, tol, dtype, what):
    got, want = got.float().detach().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **tol, err_msg=what)
    else:
        np.testing.assert_array_less(np.abs(got - want), 2.0 ** -7 * np.abs(want) + 1e-5,
                                     err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,h,ws,d", CASES)
def test_k10_plain_matches_pallas(bw, h, ws, d, dtype):
    arrays, _ = _inputs(bw, h, ws, d, seed=bw * 100 + ws * 10 + d, dtype=dtype)
    want, want_lse = jfa._win_impl(*_jax(arrays, dtype), ws)
    before = tfa.sam_window_attention.launches
    got, got_lse = tfa.sam_window_attention(*_torch(arrays, dtype), ws, return_lse=True)
    assert tfa.sam_window_attention.launches == before        # CPU: the plain version
    assert got.dtype == dtype and got_lse.dtype == torch.float32
    _close(got, want, FWD_TOL, dtype, "out")
    _close(got_lse, np.asarray(want_lse)[..., 0].reshape(bw, h, ws * ws), FWD_TOL,
           torch.float32, "lse")
    ref, ref_lse = tfa.sam_window_attention_reference(*_torch(arrays, dtype), ws)
    assert torch.equal(ref, got) and torch.equal(ref_lse, got_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,h,ws,d", CASES)
def test_k10b_plain_matches_jax_vjp(bw, h, ws, d, dtype):
    """All five gradients: the plain K10b called directly on the forward's
    out and lse, and through torch.autograd.grad of the Function, against
    jax.vjp of the Pallas kernel (its custom_vjp runs _win_bwd_kernel)."""
    arrays, go = _inputs(bw, h, ws, d, seed=bw * 100 + ws * 10 + d + 1, dtype=dtype)
    jout, pull = jax.vjp(lambda *x: jfa.sam_window_attention(*x, ws), *_jax(arrays, dtype))
    want = pull(jnp.asarray(go, jout.dtype))
    tx = _torch(arrays, dtype, grad=True)
    out, lse = tfa.sam_window_attention(*tx, ws, return_lse=True)
    g = torch.from_numpy(go).to(dtype)
    auto = torch.autograd.grad(out, tx, g)
    before = tfa.sam_window_attention_bwd.launches
    direct = tfa.sam_window_attention_bwd_reference(*[x.detach() for x in tx], ws,
                                                    out.detach(), lse, g)
    assert tfa.sam_window_attention_bwd.launches == before
    for name, a, b, w in zip(("dq", "dk", "dv", "drel_h", "drel_w"), auto, direct, want):
        assert torch.equal(a, b), name
        assert a.dtype == (dtype if name in ("dq", "dk", "dv") else torch.float32), name
        _close(a, w, GRAD_TOL, dtype, name)


@pytest.mark.parametrize("bw,h,ws,d", CASES[:3])
def test_k10_matches_k2_on_repacked_values(bw, h, ws, d):
    """tests/test_flash_attention.py:303-343 for the port: the packed-layout
    K2 and the split-layout K10 on the same values, forward and the
    gradients of qkv and rel (plain versions on the CPU: bit for bit)."""
    rng = np.random.RandomState(bw + ws + d)
    t, c = ws * ws, h * d
    qkv = torch.from_numpy(rng.randn(bw, t, 3 * c).astype(np.float32)).requires_grad_()
    rel = torch.from_numpy(rng.randn(bw, t, 2 * h * ws).astype(np.float32)).requires_grad_()
    g_out = torch.from_numpy(rng.randn(bw, t, c).astype(np.float32))

    def split(x, w):                        # [bw, t, h*w] -> [bw, h, t, w]
        return x.reshape(bw, t, h, w).transpose(1, 2)

    def split_path(qkv, rel):
        q, k, v = (split(qkv[..., i * c:(i + 1) * c], d) for i in range(3))
        out = tfa.sam_window_attention(q, k, v, split(rel[..., :h * ws], ws),
                                       split(rel[..., h * ws:], ws), ws)
        return out.transpose(1, 2).reshape(bw, t, c)

    packed = tfa.sam_window_attention_packed(qkv, rel, h, d, ws)
    split_out = split_path(qkv, rel)
    assert torch.equal(packed, split_out)
    gp = torch.autograd.grad((packed * g_out).sum(), (qkv, rel))
    gs = torch.autograd.grad((split_out * g_out).sum(), (qkv, rel))
    for name, a, b in zip(("dqkv", "drel"), gp, gs):
        assert torch.equal(a, b), name


def test_k10_wrapper_checks_shapes():
    q = torch.zeros(2, 2, 9, 8)
    rel = torch.zeros(2, 2, 9, 3)
    with pytest.raises(ValueError, match="bad shapes"):
        tfa._check_split_window("k10", q, q, q, rel, rel, 4)          # T != ws**2
    with pytest.raises(ValueError, match="bad shapes"):
        big = torch.zeros(2, 2, 9, 136)
        tfa._check_split_window("k10", big, big, big, rel, rel, 3)    # D > 128
    with pytest.raises(ValueError, match="float32"):
        qb = q.bfloat16()
        tfa._check_split_window("k10", qb, qb, qb, rel.double(), rel.double(), 3)
    assert tfa._check_split_window("k10", q.bfloat16(), q.bfloat16(), q.bfloat16(),
                                   rel, rel, 3) == 0
