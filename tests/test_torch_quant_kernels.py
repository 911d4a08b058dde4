"""The kernels of the quantized formats (plain versions here) and the decode
step over the flat quantized caches, against the JAX package with its Pallas
kernels in interpret mode.

Tolerances, fp32:
- K5 and K7: atol = rtol = 1e-5. K5 sums exact products in fp32 in another
  order; K7's three products are exact int32 and its codes agree.
- K6: atol = rtol = 1e-4. The intermediate h is rounded to bf16 before the
  down product: an fp32 ulp of difference in silu(g) * u can move h by one
  bf16 step (2^-8 relative) for a few elements.
- K4: atol = rtol = 1e-4. Per 256-key block, p * v_scale and alpha are
  rounded to bf16 (and l at the end), so an fp32 ulp of difference in a
  score can move one p by a bf16 step. The int8 scores product is exact.
- decode_step hidden states: 1e-4, for the K4 and K6 rounding points above;
  the cache bytes and scales written by the step are identical.

W8A8 quantizes every activation to int8 codes: where an fp32 ulp of
difference upstream (the plain attention sums in another order) meets a
value on the edge between two codes, that code moves by one and the
hidden states by about 1e-2 from there on, while the tokens stay the same.
The inputs of the W8A8 cases below are ones on which no code moves, so the
comparison stays at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.ops import int4 as jint4
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.runtime import generate as tgen

K4_TOL = dict(atol=1e-4, rtol=1e-4)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _cache(seed, b, l, n_kv, d, pack4):
    """A flat quantized layer-stack of 2 layers, as the JAX package writes it."""
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


def _bf16_to_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("pack4", [False, True])
@pytest.mark.parametrize("h,n_kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("qdot8,pv8", [(False, False), (True, False), (True, True)])
def test_decode_attention_q_plain_matches_jax(pack4, h, n_kv, qdot8, pv8):
    b, d, l, block = 2, 8, 32, 8
    kq, ks, vq, vs = _cache(h * 10 + n_kv + pack4, b, l, n_kv, d, pack4)
    q = np.random.RandomState(3).randn(b, h * d).astype(np.float32)
    mask = np.arange(l)[None] < np.array([[13], [29]])
    mask[0, 3] = False                                     # a hole inside the prompt
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=block,
              qdot_int8=qdot8, pv_int8=pv8)
    want = jfa.decode_attention_q(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                                  jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(mask), **kw)
    got = tfa.decode_attention_q(torch.from_numpy(q), torch.from_numpy(kq), _bf16_to_torch(ks),
                                 torch.from_numpy(vq), _bf16_to_torch(vs),
                                 torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K4_TOL)


@pytest.mark.parametrize("pack4", [False, True])
def test_decode_attention_q_valid_len_skips_blocks(pack4):
    """Blocks at or past ceil(valid_len / block) are skipped even where the
    key mask marks them valid, as in the JAX kernel."""
    b, h, n_kv, d, l, block = 2, 4, 2, 8, 32, 8
    kq, ks, vq, vs = _cache(7, b, l, n_kv, d, pack4)
    q = np.random.RandomState(4).randn(b, h * d).astype(np.float32)
    mask = np.ones((b, l), bool)
    args_t = (torch.from_numpy(q), torch.from_numpy(kq), _bf16_to_torch(ks),
              torch.from_numpy(vq), _bf16_to_torch(vs), torch.from_numpy(mask))
    args_j = tuple(jnp.asarray(a) for a in (q, kq, ks, vq, vs, mask))
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, block=block)
    for vl in (5, 13, 32):
        want = jfa.decode_attention_q(*args_j, valid_len=jnp.int32(vl), **kw)
        got = tfa.decode_attention_q(*args_t, valid_len=vl, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **K4_TOL)
        cut = torch.from_numpy(mask & (np.arange(l) < -(-vl // block) * block)[None])
        same = tfa.decode_attention_q(*args_t[:5], cut, **kw)
        torch.testing.assert_close(got, same, atol=0, rtol=0)


def test_banded_q8_matches_jax():
    q = np.random.RandomState(5).randn(3, 8 * 16).astype(np.float32)
    q[1, :16] = 0.0                                        # a zero head: the 1e-20 floor
    qb8, qs = jfa.banded_q8(jnp.asarray(q), n_kv=4, head_dim=16)
    q8, qs_t = tfa.banded_q8(torch.from_numpy(q), n_kv=4, head_dim=16)
    # JAX: qb8[b, r, kv, kv*D + dd] = q8 of head kv*n_rep + r; qs [b, r, kv]
    diag = np.stack([np.asarray(qb8)[:, :, kv, kv * 16:(kv + 1) * 16] for kv in range(4)], 2)
    np.testing.assert_array_equal(q8.numpy(), diag.transpose(0, 2, 1, 3))
    np.testing.assert_array_equal(qs_t.numpy(), np.asarray(qs).transpose(0, 2, 1))


@pytest.fixture(scope="module")
def mlp_layer():
    cfg = dataclasses.replace(LLAMA_TINY, hidden_size=128, intermediate_size=384)
    return jax.device_get(jllm.init_layer(jax.random.PRNGKey(8), cfg))


@pytest.mark.parametrize("rows", [1, 2, 5])
def test_int4_matmul_pallas_plain_matches_jax(mlp_layer, rows):
    qkv = jax.device_get(jquant.convert_attn_int4(_j(mlp_layer["attn"]), True))["qkv4"]
    x = np.random.RandomState(rows).randn(rows, 1, 128).astype(np.float32)
    want = jint4.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(qkv["w_p4"]),
                                    jnp.asarray(qkv["w_scale"]))
    qt = from_numpy_tree(qkv, "cpu")
    got = tint4.int4_matmul_pallas(torch.from_numpy(x), qt["w_p4"], qt["w_scale"])
    assert got.shape == (rows, 1, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_int4_plain_matches_jax(mlp_layer, act):
    mlp = jax.device_get(jquant.convert_mlp_int4(_j(mlp_layer["mlp"])))
    if act == "gelu":
        mlp = {"fc1": mlp["gate"], "fc2": mlp["down"]}
    x = np.random.RandomState(9).randn(3, 1, 128).astype(np.float32)
    want = jint4.fused_mlp_int4(_j(mlp), jnp.asarray(x), act)
    got = tint4.fused_mlp_int4(from_numpy_tree(mlp, "cpu"), torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_int8_plain_matches_jax(mlp_layer, act):
    mlp = {k: jquant.convert_proj(v, True) for k, v in _j(mlp_layer["mlp"]).items()}
    if act == "gelu":
        mlp = {"fc1": mlp["gate"], "fc2": mlp["down"]}
    mlp = jax.device_get(mlp)
    x = np.random.RandomState(10).randn(3, 1, 128).astype(np.float32)
    want = jint4.fused_mlp_int8(_j(mlp), jnp.asarray(x), act)
    mt = from_numpy_tree(mlp, "cpu")
    got = tint4.fused_mlp_int8(mt, torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert tint4.fused_mlp_int8(mt, torch.zeros(2, 129, 128), act) is None   # prefill rows


FORMATS = {
    "int4_flat": dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True),
    "int8_flat": dict(act_quant=True),
}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def qllm(request):
    """LLAMA_TINY widened to hidden 128 (so the fused q/k/v width 384 takes
    K5), GQA 4:2, in a production format."""
    kv = request.param
    jc = dataclasses.replace(LLAMA_TINY, hidden_size=128, num_kv_heads=2)
    tc = dataclasses.replace(tcfg.LLAMA_TINY, hidden_size=128, num_kv_heads=2)
    p = jax.device_get(jquant.quantize_llm(jllm.init(jax.random.PRNGKey(12), jc),
                                           **FORMATS[kv]))
    return kv, jc, tc, p, from_numpy_tree(p, "cpu")


def test_decode_step_flat_quant_cache_matches_jax(qllm):
    kv, jc, tc, p, pt = qllm
    b, t, l = 3, 20, 32
    rng = np.random.RandomState(17)
    # the prompt slots come from the prefill of a right-padded prompt
    emb = rng.randn(b, t, 128).astype(np.float32)
    lens = np.array([20, 14, 9])
    mask = np.arange(t)[None] < lens[:, None]
    _, pre = jllm.forward(_j(p), jc, jnp.asarray(emb), attention_mask=jnp.asarray(mask),
                          kv_cache=jllm.init_kv_cache(jc, b, t, quant=kv[:4], layout="flat"))
    _, tpre = tllm.forward(pt, tc, torch.from_numpy(emb), attention_mask=torch.from_numpy(mask),
                           kv_cache=tllm.init_kv_cache(tc, b, t, quant=kv[:4], layout="flat"))
    for name in pre:
        np.testing.assert_array_equal(tpre[name].float().numpy(),
                                      np.asarray(pre[name], np.float32), err_msg=name)
    jcache = jgen._pad_cache_len(pre, l)
    tcache = tgen._pad_cache_len(tpre, l)
    x = rng.randn(b, 1, 128).astype(np.float32)
    pos = np.arange(l)[None]
    prompt = pos < lens[:, None]
    for slot in (None, t):
        # the step's own key: at each row's cache_len, or at the shared slot
        km = prompt | (pos == (lens[:, None] if slot is None else slot))
        want, wc = jllm.decode_step(_j(p), jc, dict(jcache), jnp.asarray(x),
                                    jnp.asarray(lens), jnp.asarray(km),
                                    write_slot=None if slot is None else jnp.int32(slot),
                                    valid_len=jnp.int32(21))
        got, tc_ = tllm.decode_step(pt, tc, {k: v.clone() for k, v in tcache.items()},
                                    torch.from_numpy(x), torch.from_numpy(lens),
                                    torch.from_numpy(km), write_slot=slot, valid_len=21)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        for name in wc:
            np.testing.assert_array_equal(tc_[name].float().numpy(),
                                          np.asarray(wc[name], np.float32), err_msg=name)


def test_greedy_generate_quantized_cache_tokens_identical(qllm, monkeypatch):
    kv, jc, tc, p, pt = qllm
    rng = np.random.RandomState(17)
    emb = rng.randn(3, 11, 128).astype(np.float32)
    mask = np.arange(11)[None] < np.array([[11], [7], [4]])
    want = jgen.greedy_generate(_j(p), jc, jnp.asarray(emb), jnp.asarray(mask),
                                max_new_tokens=6, eos_id=-1, kv_quant=kv)
    calls = {}
    for mod, name in ((tfa, "decode_attention_q_reference"),
                      (tint4, "int4_matmul_pallas_reference"),
                      (tint4, "fused_mlp_int4_reference"), (tint4, "fused_mlp_int8_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _fn(*a, **k))[1])
    got = tgen.greedy_generate(pt, tc, torch.from_numpy(emb), torch.from_numpy(mask),
                               max_new_tokens=6, eos_id=-1, kv_quant=kv)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden),
                               atol=1e-4, rtol=1e-4)
    # the prefill's 33 rows are few enough for K5 and K7 too (not for K6,
    # which takes single-token steps only)
    layers, steps = tc.num_layers, 6
    expect = {"decode_attention_q_reference": layers * steps}
    if kv == "int4_flat":      # K5: q/k/v per layer per step and prefill, the head per pick
        expect.update(int4_matmul_pallas_reference=layers * (steps + 1) + steps + 1,
                      fused_mlp_int4_reference=layers * steps)
    else:
        expect.update(fused_mlp_int8_reference=layers * (steps + 1))
    assert calls == expect
