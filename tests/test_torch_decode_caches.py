"""Decode over every KV-cache layout of the port against the JAX package (Pallas
in interpret mode there, the plain kernel versions here): the K8 and K11
plain versions, `llm.decode_chunk` and `llm.decode_step` over the heads fp,
heads int8 / int4, flat fp and flat int8 / int4 caches, greedy decode with
`fused_decode`, and the heads-layout quantized cache end to end.

Tolerances, fp32:
- K8 plain against JAX: atol 1e-5. The int8 scores are exact integers times
  the same scale product; p * vs, alpha and l round to bf16 at the same
  points, so only the fp32 order of the value sums differs.
- K8 plain against K4 plain position by position: atol 1e-6, the same walk
  with the value sums over another tensor shape.
- K11 plain against JAX: atol 2e-5 (fp32 cache; the JAX test's own limit),
  and for a bf16 cache 8e-3, one bf16 step of outputs of order one.
- decode_chunk / decode_step hidden states: atol 1e-4 (K4/K8 round to bf16
  inside, so an fp32 ulp of difference upstream can move a p by a bf16
  step); cache codes and scales bit for bit, fp cache values within 1e-5.
- greedy tokens identical, predictor hidden states within 2e-4.
- generate_and_segment: tokens, lengths and [SEG] rows identical, masks and
  scores within 1e-4 (tests/test_torch_walkgpt.py says why)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.runtime import generate as tgen

TCFG = tcfg.LLAMA_TINY
CACHES = ["heads", "int8", "int4", "flat", "int8_flat", "int4_flat"]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _layout(kind):
    """(layout, quant) of a cache kind."""
    if kind.endswith("flat"):
        return "flat", kind[:4] if kind != "flat" else ""
    return "heads", "" if kind == "heads" else kind


def _assert_caches_equal(got, want):
    for name in want:
        w = np.asarray(want[name]).astype(np.float32)
        g = got[name].float().numpy()
        if got[name].dtype in (torch.int8, torch.bfloat16):       # codes, scales
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def _quant_cache(seed, b, l, n_kv, d, pack4):
    """One flat quantized cache of 2 layers, as the JAX package writes it."""
    rng = np.random.RandomState(seed)
    k = jnp.asarray(rng.randn(2, b, l, n_kv, d).astype(np.float32))
    v = jnp.asarray(rng.randn(2, b, l, n_kv, d).astype(np.float32))
    if pack4:
        (kq, ks), (vq, vs) = jllm._quant_pack4_flat(k), jllm._quant_pack4_flat(v)
    else:
        (kq, ks), (vq, vs) = jllm._quant_rows(k, jnp.int8), jllm._quant_rows(v, jnp.int8)
        kq, vq = kq.reshape(2, b, l, n_kv * d), vq.reshape(2, b, l, n_kv * d)
        ks, vs = ks[..., 0], vs[..., 0]
    return [np.asarray(a) for a in (kq, ks.transpose(0, 1, 3, 2), vq, vs.transpose(0, 1, 3, 2))]


# ---------------------------------------------------------------------------
# K8 and K11 plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack4", [False, True])
@pytest.mark.parametrize("qdot8", [True, False])
@pytest.mark.parametrize("n_kv,n_rep", [(2, 1), (3, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("tc", [1, 4])
def test_decode_attention_q_chunk_plain_matches_jax(pack4, qdot8, n_kv, n_rep, tc):
    b, d, l, block = 2, 8, 32, 8
    kq, ks, vq, vs = _quant_cache(n_kv * 10 + n_rep + tc, b, l, n_kv, d, pack4)
    q = np.random.RandomState(tc + n_rep).randn(b, tc, n_kv * n_rep * d).astype(np.float32)
    cl = np.array([21, 6], np.int32)                      # ragged rows: 3 and 2 blocks
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=block, qdot_int8=qdot8)
    want = jfa.decode_attention_q_chunk(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                                        jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(cl), **kw)
    got = tfa.decode_attention_q_chunk(_t(q), _t(kq), _bf16(ks), _t(vq), _bf16(vs), _t(cl), **kw)
    assert got.shape == (b, tc, n_kv * n_rep * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("pack4", [False, True])
@pytest.mark.parametrize("qdot8", [True, False])
def test_chunk_token_is_the_decode_step_at_its_position(pack4, qdot8):
    """K8's token t computes K4's output with key_mask = pos < cl + t + 1
    and valid_len = cl + t + 1: the blocks K8 visits beyond K4's hold no
    valid key for t and leave its state as it was."""
    b, n_kv, d, l, block, tc = 2, 3, 8, 48, 8, 6
    kq, ks, vq, vs = _quant_cache(7, b, l, n_kv, d, pack4)
    q = _t(np.random.RandomState(8).randn(b, tc, 2 * n_kv * d).astype(np.float32))
    cl = torch.tensor([30, 9])
    cache = (_t(kq), _bf16(ks), _t(vq), _bf16(vs))
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, block=block, qdot_int8=qdot8)
    out = tfa.decode_attention_q_chunk_reference(q, *cache, cl, **kw)
    pos = torch.arange(l)[None]
    for t in range(tc):
        for r in range(b):
            end = int(cl[r]) + t + 1
            step = tfa.decode_attention_q_reference(q[r:r + 1, t], *(c[:, r:r + 1] for c in cache),
                                                    pos < end, valid_len=end, **kw)
            torch.testing.assert_close(out[r:r + 1, t], step, atol=1e-6, rtol=0)


def test_banded_q8_chunk_matches_jax():
    q = np.random.RandomState(5).randn(2, 3, 6 * 8).astype(np.float32)
    q[1, 2, :8] = 0.0                                       # a zero head: the 1e-20 floor
    band, qs = jfa.banded_q8_chunk(jnp.asarray(q), n_kv=3, head_dim=8)
    q8, qs_t = tfa.banded_q8_chunk(_t(q), n_kv=3, head_dim=8)
    # JAX: band[b, r, t*n_kv + kv, kv*D + dd] = q8 of (t, head kv*n_rep + r)
    band = np.asarray(band).reshape(2, 2, 3, 3, 3 * 8)
    diag = np.stack([band[:, :, :, kv, kv * 8:(kv + 1) * 8] for kv in range(3)], 3)
    np.testing.assert_array_equal(q8.numpy(), diag.transpose(0, 2, 3, 1, 4))
    np.testing.assert_array_equal(qs_t.numpy(),
                                  np.asarray(qs).reshape(2, 2, 3, 3).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), ("bfloat16", 8e-3)])
@pytest.mark.parametrize("h,n_kv", [(4, 2), (6, 3), (4, 4)])
def test_decode_attention_plain_matches_jax(dtype, atol, h, n_kv):
    b, d, l = 2, 8, 24
    rng = np.random.RandomState(h + n_kv)
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((b, h * d), (2, b, l, n_kv * d), (2, b, l, n_kv * d)))
    mask = np.arange(l)[None] < np.array([[5], [19]])
    mask[1, 2] = False                                      # a hole inside the prompt
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    want = jfa.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask),
                                n_kv=n_kv, layer=1, block=8)
    got = tfa.decode_attention(*(_t(a).to(tdt) for a in (q, k, v)), _t(mask), n_kv=n_kv,
                               layer=1, block=8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# decode_chunk and decode_step over every cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    p = jax.device_get(jllm.init(jax.random.PRNGKey(5), LLAMA_TINY))
    return p, from_numpy_tree(p, "cpu")


def _prefilled(p, pt, kind, emb, mask, l_max):
    """The JAX and the port's caches of one prompt prefill, equal, grown to l_max."""
    layout, quant = _layout(kind)
    b, t, _ = emb.shape
    _, jc = jllm.forward(_j(p), LLAMA_TINY, jnp.asarray(emb), attention_mask=jnp.asarray(mask),
                         kv_cache=jllm.init_kv_cache(LLAMA_TINY, b, t, quant=quant,
                                                     layout=layout))
    _, tc = tllm.forward(pt, TCFG, _t(emb), attention_mask=_t(mask),
                         kv_cache=tllm.init_kv_cache(TCFG, b, t, quant=quant, layout=layout))
    _assert_caches_equal(tc, jc)
    return jgen._pad_cache_len(jc, l_max), tgen._pad_cache_len(tc, l_max)


@pytest.mark.parametrize("kind", ["heads", "int8", "int4", "int8_flat", "int4_flat"])
def test_decode_chunk_matches_jax(tiny, kind):
    """Two chunks of 4: the first runs past the end of an 8-slot cache in
    row 0 (slots 8, 9 dropped), the second lies wholly past it in row 0."""
    p, pt = tiny
    rng = np.random.RandomState(4)
    emb = rng.randn(2, 6, 64).astype(np.float32)
    mask = np.arange(6)[None] < np.array([[6], [3]])
    jc, tc = _prefilled(p, pt, kind, emb, mask, 8)
    for cache_len in (np.array([6, 3], np.int32), np.array([8, 4], np.int32)):
        x = rng.randn(2, 4, 64).astype(np.float32)
        want, jc = jllm.decode_chunk(_j(p), LLAMA_TINY, jc, jnp.asarray(x), jnp.asarray(cache_len))
        got, tc = tllm.decode_chunk(pt, TCFG, tc, _t(x), _t(cache_len).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        _assert_caches_equal(tc, jc)


def test_decode_chunk_refuses_the_flat_fp_cache(tiny):
    _, pt = tiny
    cache = tllm.init_kv_cache(TCFG, 1, 8, layout="flat")
    with pytest.raises(ValueError, match="quantized"):
        tllm.decode_chunk(pt, TCFG, cache, torch.zeros(1, 2, 64), torch.tensor([3]))


@pytest.mark.parametrize("kind", ["int8", "int4", "flat"])
def test_decode_step_matches_jax(tiny, kind):
    p, pt = tiny
    b, t, l = 3, 10, 16
    rng = np.random.RandomState(17)
    emb = rng.randn(b, t, 64).astype(np.float32)
    lens = np.array([10, 7, 4])
    jcache, tcache = _prefilled(p, pt, kind, emb, np.arange(t)[None] < lens[:, None], l)
    x = rng.randn(b, 1, 64).astype(np.float32)
    pos = np.arange(l)[None]
    for slot in (None, t):
        km = (pos < lens[:, None]) | (pos == (lens[:, None] if slot is None else slot))
        want, wc = jllm.decode_step(_j(p), LLAMA_TINY, dict(jcache), jnp.asarray(x),
                                    jnp.asarray(lens), jnp.asarray(km),
                                    write_slot=None if slot is None else jnp.int32(slot))
        got, gc = tllm.decode_step(pt, TCFG, {k: v.clone() if torch.is_tensor(v) else v
                                              for k, v in tcache.items()},
                                   _t(x), _t(lens), _t(km), write_slot=slot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        _assert_caches_equal(gc, wc)


# ---------------------------------------------------------------------------
# greedy decode over the flat fp and the heads quantized caches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prompt():
    emb = np.random.RandomState(93).randn(2, 7, 64).astype(np.float32)
    return emb, np.array([[True] * 7, [True] * 5 + [False] * 2])


def test_greedy_fused_decode_matches_jax_and_heads(tiny, prompt, monkeypatch):
    p, pt = tiny
    emb, mask = prompt
    jf = dataclasses.replace(LLAMA_TINY, fused_decode=True)
    tf = dataclasses.replace(TCFG, fused_decode=True)
    want = jgen.greedy_generate(_j(p), jf, jnp.asarray(emb), jnp.asarray(mask),
                                max_new_tokens=6, eos_id=-1)
    calls = []
    ref = tfa.decode_attention_reference
    monkeypatch.setattr(tfa, "decode_attention_reference",
                        lambda *a, **k: (calls.append(1), ref(*a, **k))[1])
    got = tgen.greedy_generate(pt, tf, _t(emb), _t(mask), max_new_tokens=6, eos_id=-1)
    assert len(calls) == TCFG.num_layers * 6                 # K11 in every step and layer
    heads = tgen.greedy_generate(pt, TCFG, _t(emb), _t(mask), max_new_tokens=6, eos_id=-1)
    for other in (np.asarray(want.tokens), heads.tokens.numpy()):
        np.testing.assert_array_equal(got.tokens.numpy(), other)
    for other in (np.asarray(want.pred_hidden), heads.pred_hidden.numpy()):
        np.testing.assert_allclose(got.pred_hidden.numpy(), other, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kv", ["int8", "int4", True])
def test_greedy_heads_quant_cache_matches_jax(tiny, prompt, kv):
    p, pt = tiny
    emb, mask = prompt
    want = jgen.greedy_generate(_j(p), LLAMA_TINY, jnp.asarray(emb), jnp.asarray(mask),
                                max_new_tokens=6, eos_id=-1, kv_quant=kv)
    got = tgen.greedy_generate(pt, TCFG, _t(emb), _t(mask), max_new_tokens=6, eos_id=-1,
                               kv_quant=kv)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden),
                               atol=1e-4, rtol=0)


def test_int4_heads_codes_are_jax_int4_values():
    x = np.random.RandomState(3).randn(2, 3, 5, 16).astype(np.float32) * 3
    jq, js = jllm._quant_rows(jnp.asarray(x), jnp.int4)
    tq, ts = tllm._quant_rows(_t(x), 7)
    assert tq.dtype == torch.int8 and int(tq.abs().max()) == 7
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32)[..., 0])


# ---------------------------------------------------------------------------
# the heads-layout quantized cache end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def walk():
    p = jax.device_get(jwalk.init(jax.random.PRNGKey(0), jcfg.tiny_config().replace(clip=None)))
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200                  # <image> sentinels
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    pt = from_numpy_tree(p, "cpu")
    probe = twalk.generate_and_segment(pt, tcfg.tiny_config(), max_new_tokens=8, max_segs=8,
                                       eos_id=-1, device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe[1:], return_counts=True)
    return p, pt, inputs, int(vals[np.argmax(counts)])


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_generate_and_segment_heads_quant_cache_matches_jax(walk, kv):
    p, pt, inputs, seg = walk
    jc = jcfg.tiny_config(seg_token_id=seg).replace(clip=None, kv_quant_cache=kv,
                                                     use_flash_attention=True)
    tc = tcfg.tiny_config(seg_token_id=seg).replace(kv_quant_cache=kv, use_flash_attention=True)
    want = jwalk.generate_and_segment(_j(p), jc, max_new_tokens=8, max_segs=8, eos_id=-1,
                                      **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = twalk.generate_and_segment(pt, tc, max_new_tokens=8, max_segs=8, eos_id=-1,
                                     device="cpu", **inputs)
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any()
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.mask_scores.numpy(), np.asarray(want.mask_scores),
                               atol=1e-4, rtol=0)
