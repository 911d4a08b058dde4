"""`--precision fp16` in the PyTorch port against the JAX package: the plain
versions of the four kernels with an fp16 route (K1 flash_attention, K4
decode_attention_q, K5 int4_matmul_pallas, K6 fused_mlp_int4) against the
TPU kernels in interpret mode on the same fp16 inputs, and a tiny
generate_and_segment built as runtime/evaluate.build_model builds it at
fp16 (fp16 parameters, fp32 images: the SAM encoder runs in fp32, the LLM
in fp16).

Tolerances. Every kernel computes in fp32 and rounds its output to fp16 once
(K4 and K6 also round to bf16 at the TPU kernel's own points, whatever the
input type), so the two packages differ by the order of fp32 sums: outputs
within one fp16 step of their size (rtol 1e-3, atol 1e-3 times the largest
magnitude), K6 within two (its bf16 intermediate can move by one bf16 step
where an fp32 ulp meets a rounding edge). The pipeline: tokens, lengths and
seg rows identical; mask logits within 2e-2 of logits of order ten (fp16
hidden states and [SEG] embeddings feed the fp32 mask decoder)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.ops import int4 as jint4
from walkgpt_tpu.ops.quant import quantize_llm as jquantize_llm
from walkgpt_tpu.ops.quant import quantize_sam_encoder as jquantize_sam
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import int4 as tint4

F16 = np.float16


def _close(got: torch.Tensor, want, steps: int = 1):
    w = np.asarray(want).astype(np.float32)
    assert got.dtype == torch.float16
    scale = float(np.abs(w).max())
    np.testing.assert_allclose(got.float().numpy(), w, rtol=steps * 1e-3,
                               atol=steps * 1e-3 * scale)


@pytest.mark.parametrize("causal", [True, False])
def test_k1_fp16_plain_matches_jax(causal):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 2, 37, 32).astype(F16) for _ in range(3))
    kv = np.arange(37)[None] < np.array([[37], [29]])
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                               key_valid=jnp.asarray(kv))
    assert want.dtype == jnp.float16
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                              key_valid=torch.from_numpy(kv))
    _close(got, want)


def _flat_cache(rng, b, l, n_kv, d, pack4):
    from walkgpt_tpu.models import llm as jllm
    k = jnp.asarray(rng.randn(2, b, l, n_kv, d).astype(np.float32))
    v = jnp.asarray(rng.randn(2, b, l, n_kv, d).astype(np.float32))
    if pack4:
        (kq, ks), (vq, vs) = jllm._quant_pack4_flat(k), jllm._quant_pack4_flat(v)
    else:
        (kq, ks), (vq, vs) = jllm._quant_rows(k, jnp.int8), jllm._quant_rows(v, jnp.int8)
        kq, vq = kq.reshape(2, b, l, n_kv * d), vq.reshape(2, b, l, n_kv * d)
        ks, vs = ks[..., 0], vs[..., 0]
    return [np.array(a) for a in (kq, ks.transpose(0, 1, 3, 2), vq, vs.transpose(0, 1, 3, 2))]


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("qdot8,pv8", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("pack4", [False, True])
def test_k4_fp16_plain_matches_jax(pack4, qdot8, pv8):
    rng = np.random.RandomState(2)
    b, n_kv, n_rep, d, l = 2, 2, 2, 32, 64
    kc, ks, vc, vs = _flat_cache(rng, b, l, n_kv, d, pack4)
    q = rng.randn(b, n_kv * n_rep * d).astype(F16)
    key_mask = np.arange(l)[None] < np.array([[40], [23]])
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=32, valid_len=40,
              qdot_int8=qdot8, pv_int8=pv8)
    want = jfa.decode_attention_q(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks),
                                  jnp.asarray(vc), jnp.asarray(vs), jnp.asarray(key_mask), **kw)
    assert want.dtype == jnp.float16
    got = tfa.decode_attention_q(torch.from_numpy(q), torch.from_numpy(kc), _bf16(ks),
                                 torch.from_numpy(vc), _bf16(vs), torch.from_numpy(key_mask),
                                 **kw)
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 4])
def test_k5_fp16_plain_matches_jax(rows):
    rng = np.random.RandomState(3)
    w = jint4.quantize_weight4(jnp.asarray(rng.randn(96, 256).astype(np.float32)))
    x = rng.randn(rows, 96).astype(F16)
    want = jint4.int4_matmul_pallas(jnp.asarray(x), w["w_p4"], w["w_scale"])
    assert want.dtype == jnp.float16
    got = tint4.int4_matmul_pallas(torch.from_numpy(x), torch.from_numpy(np.asarray(w["w_p4"])),
                                   torch.from_numpy(np.asarray(w["w_scale"])))
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_k6_fp16_plain_matches_jax(act):
    rng = np.random.RandomState(4)
    h, i_dim = 64, 512
    names = ("gate", "up", "down") if act == "silu" else ("fc1", "fc2")
    mlp = {}
    for name in names:
        shape = (i_dim, h) if name in ("down", "fc2") else (h, i_dim)
        wf = jnp.asarray(0.2 * rng.randn(*shape).astype(np.float32))
        mlp[name] = (jint4.pack_down4(wf) if name in ("down", "fc2")
                     else jint4.quantize_weight4(wf))
    mlp = jax.device_get(mlp)
    x = rng.randn(3, 1, h).astype(F16)
    want = jint4.fused_mlp_int4(jax.tree_util.tree_map(jnp.asarray, mlp), jnp.asarray(x), act)
    assert want.dtype == jnp.float16
    got = tint4.fused_mlp_int4(from_numpy_tree(mlp, "cpu"), torch.from_numpy(x), act)
    _close(got, want, steps=2)


INT4X = dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)


@pytest.mark.parametrize("fmt", ["dense", "int4x"])
def test_fp16_generate_and_segment_matches_jax(fmt):
    """evaluate.build_model at --precision fp16 (and --quant int4x
    --sam_quant int8 --kv_cache int4_flat for int4x, the LLM widened to
    hidden 128 so that K5 takes its tiles): init in fp16, then the
    quantizers; the images stay fp32."""
    jc = jcfg.tiny_config().replace(clip=None, use_flash_attention=True)
    tc = tcfg.tiny_config().replace(use_flash_attention=True)
    if fmt == "int4x":
        jc = jc.replace(llm=dataclasses.replace(jc.llm, hidden_size=128),
                        kv_quant_cache="int4_flat")
        tc = tc.replace(llm=dataclasses.replace(tc.llm, hidden_size=128),
                        kv_quant_cache="int4_flat")
    p = jwalk.init(jax.random.PRNGKey(0), jc, dtype=jnp.float16)
    if fmt == "int4x":
        p = dict(p, llm=jquantize_llm(p["llm"], **INT4X), sam=jquantize_sam(p["sam"]))
    p = jax.device_get(p)
    assert p["llm"]["embed_tokens"]["w"].dtype == F16
    pt = from_numpy_tree(p, "cpu")
    rng = np.random.RandomState(8)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    probe = twalk.generate_and_segment(pt, tc, max_new_tokens=6, max_segs=8, eos_id=-1,
                                       device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe, return_counts=True)
    seg = int(vals[np.argmax(counts)])
    want = jwalk.generate_and_segment(
        jax.tree_util.tree_map(jnp.asarray, p), jc.replace(seg_token_id=seg), max_new_tokens=6,
        max_segs=8, eos_id=-1, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = twalk.generate_and_segment(pt, tc.replace(seg_token_id=seg), max_new_tokens=6,
                                     max_segs=8, eos_id=-1, device="cpu", **inputs)
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any()
    assert torch.isfinite(got.pred_masks).all()
    for name in ("pred_masks", "mask_scores"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   np.asarray(getattr(want, name), np.float32),
                                   atol=2e-2, rtol=0, err_msg=name)
