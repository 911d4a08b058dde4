"""ops/losses.py of the port against walkgpt_tpu/ops/losses.py on the same
numpy inputs, with and without the validity masks of the padded training
batch, and the TinyCrossAttn pooling the InfoNCE loss runs.

Tolerance: fp32, atol = rtol = 1e-5 (another summation order in the
means, the softmaxes and the dice sums); top-k indices identical (random
logits have no ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.models import projectors as jproj
from walkgpt_tpu.ops import losses as jl
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import projectors as tproj
from walkgpt_tpu_torch.ops import losses as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _masks(rng, n=5, hw=(12, 10)):
    logits = (3 * rng.randn(n, *hw)).astype(np.float32)
    targets = rng.rand(n, *hw) > 0.6
    valid = np.array([True, True, False, True, False][:n])
    return logits, targets, valid


@pytest.mark.parametrize("use_valid", [False, True])
def test_dice_and_sigmoid_ce_match_jax(use_valid):
    rng = np.random.RandomState(0)
    logits, targets, valid = _masks(rng)
    kw_j = dict(valid=jnp.asarray(valid)) if use_valid else {}
    kw_t = dict(valid=_t(valid)) if use_valid else {}
    num = float(valid.sum()) if use_valid else 5.0
    np.testing.assert_allclose(
        float(tl.dice_loss(_t(logits), _t(targets), num, **kw_t)),
        float(jl.dice_loss(jnp.asarray(logits), jnp.asarray(targets), num, **kw_j)), **TOL)
    np.testing.assert_allclose(
        float(tl.sigmoid_ce_loss(_t(logits), _t(targets), num, **kw_t)),
        float(jl.sigmoid_ce_loss(jnp.asarray(logits), jnp.asarray(targets), num, **kw_j)),
        **TOL)


@pytest.mark.parametrize("counts", [[2, 3], [1, 1, 3], [5], [2, 2]])
def test_overlap_loss_matches_jax(counts):
    """[2, 2] leaves the fifth mask outside every question: it counts in no
    overlap and takes the last question's weight, as in JAX."""
    rng = np.random.RandomState(len(counts))
    logits, targets, _ = _masks(rng)
    want = jl.overlap_loss(jnp.asarray(logits), jnp.asarray(targets), 5.0, np.array(counts))
    got = tl.overlap_loss(_t(logits), _t(targets), 5.0, np.array(counts))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(tl.overlap_loss(_t(logits[:0]), _t(targets[:0]), 0.0, [])) == 0.0


def test_l2norm_and_cross_entropy_with_smoothing_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(7, 9).astype(np.float32)
    x[3] = 0.0                                   # the eps floor
    np.testing.assert_allclose(tl._l2norm(_t(x)).numpy(), np.asarray(jl._l2norm(jnp.asarray(x))),
                               **TOL)
    logits = (2 * rng.randn(11, 23)).astype(np.float32)
    labels = rng.randint(0, 23, size=11)
    labels[[1, 4, 5]] = -100
    for eps in (0.0, 0.1):
        np.testing.assert_allclose(
            float(tl.cross_entropy_with_smoothing(_t(logits), _t(labels), label_smoothing=eps)),
            float(jl.cross_entropy_with_smoothing(jnp.asarray(logits), jnp.asarray(labels),
                                                  label_smoothing=eps)), **TOL)
    none = np.full(11, -100)                      # no trained label: 0, not NaN
    assert float(tl.cross_entropy_with_smoothing(_t(logits), _t(none))) == 0.0


@pytest.fixture(scope="module")
def xattn():
    return jax.device_get(jproj.tiny_xattn_init(jax.random.PRNGKey(3), 16))


def test_tiny_xattn_apply_matches_jax(xattn):
    rng = np.random.RandomState(2)
    q = rng.randn(4, 16).astype(np.float32)
    kv = rng.randn(4, 13, 16).astype(np.float32)
    want_v, want_a = jproj.tiny_xattn_apply(xattn, jnp.asarray(q), jnp.asarray(kv))
    got_v, got_a = tproj.tiny_xattn_apply(from_numpy_tree(xattn, "cpu"), _t(q), _t(kv))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


@pytest.mark.parametrize("top_k,exclude,masks", [(8, True, True), (None, True, False),
                                                 (4, False, False), (8, True, False),
                                                 (20, True, True)])
def test_infonce_matches_jax(xattn, top_k, exclude, masks):
    """Top-k refinement (20 >= the 16 tokens: none), same-row exclusion, and
    the valid / row_valid masks of the padded batch."""
    rng = np.random.RandomState(5)
    emb = rng.randn(6, 16).astype(np.float32)
    tokens = rng.randn(3, 16, 16).astype(np.float32)
    rows = np.array([0, 0, 1, 2, 2, 0])
    kw_j, kw_t = {}, {}
    if masks:
        valid, row_valid = np.array([1, 1, 1, 0, 1, 0], bool), np.array([1, 1, 0], bool)
        kw_j = dict(valid=jnp.asarray(valid), row_valid=jnp.asarray(row_valid))
        kw_t = dict(valid=_t(valid), row_valid=_t(row_valid))
    want, aux = jl.infonce_loss(jnp.asarray(emb), jnp.asarray(tokens), jnp.asarray(rows), xattn,
                                top_k=top_k, exclude_same_row=exclude, return_aux=True, **kw_j)
    got, taux = tl.infonce_loss(_t(emb), _t(tokens), _t(rows), from_numpy_tree(xattn, "cpu"),
                                top_k=top_k, exclude_same_row=exclude, return_aux=True, **kw_t)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(taux["v_pos"].numpy(), np.asarray(aux["v_pos"]), **TOL)
    np.testing.assert_allclose(taux["logits"].numpy(), np.asarray(aux["logits"]), **TOL)


def test_infonce_gradient_matches_jax(xattn):
    """The loss's gradient in the embeddings and the pooling weights (the
    CTP and TinyCrossAttn side of the training step)."""
    rng = np.random.RandomState(6)
    emb = rng.randn(5, 16).astype(np.float32)
    tokens = rng.randn(2, 16, 16).astype(np.float32)
    rows = np.array([0, 1, 1, 0, 1])
    jfn = lambda e, p: jl.infonce_loss(e, jnp.asarray(tokens), jnp.asarray(rows), p, top_k=8)
    ge, gp = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(emb), xattn)
    te = _t(emb).requires_grad_()
    tp = from_numpy_tree(xattn, "cpu")
    for v in tp.values():
        v["w"].requires_grad_()
    tl.infonce_loss(te, _t(tokens), _t(rows), tp, top_k=8).backward()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **TOL)
    for name in tp:        # wv and out get none: top-k pools the raw tokens
        grad = tp[name]["w"].grad
        grad = torch.zeros_like(tp[name]["w"]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(gp[name]["w"]), **TOL,
                                   err_msg=name)
    assert tp["wq"]["w"].grad.abs().max() > 0


def test_empty_infonce_is_zero(xattn):
    got = tl.infonce_loss(torch.zeros(0, 16), torch.zeros(2, 4, 16),
                          torch.zeros(0, dtype=torch.long), from_numpy_tree(xattn, "cpu"))
    assert float(got) == 0.0
