"""K12, the fused decode-layer tail, against the JAX package on the CPU:

1. `ops/fused_layer.fused_layer_tail` (its plain version on CPU tensors)
   against JAX's `fused_layer_tail` in Pallas interpret mode, on the inputs
   of tests/test_flash_attention.py's fused-tail test with the MLP widened
   to three intermediate tiles: int8 and packed int4 caches, the silu
   gate/up MLP and the gelu fc1/fc2 MLP, valid_len None (every block) and
   set (the second length block skipped), 8-key blocks over 16 slots.
   Tolerance: the fp32 output within 2 bf16 steps (2^-7) of its largest
   magnitude. Both sides round at the same points (bf16 x2, hn and h);
   the sums of the norm and the MLP run in another order, so a value on
   the edge of a bf16 step may land on either side and move the output by
   one bf16 step of a term.
2. `layer_tail_supported` equals JAX's on the layers of every format
   `init_quantized` builds.
3. The slice end to end: `generate_and_segment(fused_layer=True)` at
   tiny_config in WalkGPT-7B's int4x format over the int4_flat cache, the
   LLM widened to hidden 128 (MHA, 4 heads of 32) and intermediate 384 (3
   MLP tiles), against JAX's with `walkgpt_tpu.ops.fused_layer.FUSED_LAYER`
   patched on. JAX reads that flag while tracing, so the test clears JAX's
   caches and counts the traces of its fused_layer_tail: a run that never
   took the fused branch fails. Tokens, lengths and [SEG] rows identical;
   masks and scores within atol 1e-4 (tests/test_torch_quant_walkgpt.py's
   limits); the port's decode steps never ran K4 or K6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.ops import fused_layer as jfl
from walkgpt_tpu.ops import int4 as jint4
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import fused_layer as tfl
from walkgpt_tpu_torch.ops import int4 as tint4


def _tail_inputs(seed, pack4, gelu, lengths, x_dtype):
    """Numpy inputs of one fused layer tail: b 2, 2 heads of 8 (MHA), 16
    cache slots, intermediate 96 (3 tiles of 32)."""
    rng = np.random.RandomState(seed)
    b, h, n_kv, d, l, i_dim = 2, 2, 2, 8, 16, 96
    hd = h * d
    k = jnp.asarray(rng.randn(b, l, n_kv, d), jnp.float32)
    v = jnp.asarray(rng.randn(b, l, n_kv, d), jnp.float32)
    if pack4:
        (kq, ks), (vq, vs) = jllm._quant_pack4_flat(k), jllm._quant_pack4_flat(v)
        width = n_kv * d // 2
    else:
        (kq, ks), (vq, vs) = jllm._quant_rows(k, jnp.int8), jllm._quant_rows(v, jnp.int8)
        ks, vs = ks[..., 0], vs[..., 0]
        width = n_kv * d
    w = lambda *shape: jnp.asarray(rng.randn(*shape) * 0.05, jnp.float32)
    if gelu:
        mlp = {"fc1": jint4.quantize_weight4(w(hd, i_dim)), "fc2": jint4.pack_down4(w(i_dim, hd))}
    else:
        mlp = {"gate": jint4.quantize_weight4(w(hd, i_dim)),
               "up": jint4.quantize_weight4(w(hd, i_dim)), "down": jint4.pack_down4(w(i_dim, hd))}
    arrays = dict(
        x=jnp.asarray(rng.randn(b, hd) * 0.1, x_dtype),
        q=jnp.asarray(rng.randn(b, hd), jnp.float32),
        k=jnp.asarray(kq).reshape(b, l, width)[None], ks=jnp.asarray(ks).transpose(0, 2, 1)[None],
        v=jnp.asarray(vq).reshape(b, l, width)[None], vs=jnp.asarray(vs).transpose(0, 2, 1)[None],
        mask=jnp.arange(l)[None, :] < jnp.asarray(lengths)[:, None],
        o=jquant.convert_proj({"w": w(hd, hd)}, True),
        pn=jnp.asarray(1.0 + 0.1 * rng.randn(hd), jnp.float32), mlp=mlp)
    return jax.device_get(arrays), dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0,
                                        act="gelu" if gelu else "silu", norm_eps=1e-6, block=8)


@pytest.mark.parametrize("pack4", [False, True])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("lengths,valid_len,x_dtype", [
    ([5, 11], None, jnp.bfloat16),
    ([5, 7], 7, jnp.bfloat16),
    ([16, 9], None, jnp.float32),
])
def test_fused_layer_tail_matches_jax_interpret(pack4, gelu, lengths, valid_len, x_dtype):
    a, kw = _tail_inputs(3, pack4, gelu, lengths, x_dtype)
    j = jax.tree_util.tree_map(jnp.asarray, a)
    qb8, qs8 = jfa.banded_q8(j["q"], n_kv=kw["n_kv"], head_dim=kw["head_dim"])
    want = np.asarray(jfl.fused_layer_tail(
        j["x"], qb8, qs8, j["k"], j["ks"], j["v"], j["vs"], j["mask"], j["o"], j["pn"],
        j["mlp"], valid_len=valid_len, **kw), np.float32)
    t = from_numpy_tree(a, "cpu")
    q8, qs = tfa.banded_q8(t["q"], n_kv=kw["n_kv"], head_dim=kw["head_dim"])
    got = tfl.fused_layer_tail(t["x"], q8, qs, t["k"], t["ks"], t["v"], t["vs"], t["mask"],
                               t["o"], t["pn"], t["mlp"], valid_len=valid_len, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tfl.fused_layer_tail.launches == 0                # CPU tensors: the plain version
    err = np.abs(got.numpy() - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max(), err


def test_fused_layer_tail_rejects_gqa():
    a, kw = _tail_inputs(4, True, False, [5, 11], jnp.bfloat16)
    t = from_numpy_tree(a, "cpu")
    q8, qs = tfa.banded_q8(t["q"], n_kv=1, head_dim=8)
    with pytest.raises(ValueError, match="MHA"):
        tfl.fused_layer_tail(t["x"], q8, qs, t["k"], t["ks"], t["v"], t["vs"], t["mask"],
                             t["o"], t["pn"], t["mlp"], **{**kw, "n_kv": 1})


FORMATS = [dict(), dict(act_quant=True), dict(act_quant=True, sam_int8=True),
           dict(mlp_int4=True), dict(act_quant=True, mlp_int4=True),
           dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True, sam_int8=True),
           dict(attn_int4_proj=True, mlp_int4=True), dict(act_quant=True, attn_int4_proj=True)]


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: "+".join(sorted(f)) or "bits")
def test_layer_tail_supported_matches_jax(fmt):
    jc = jcfg.tiny_config().replace(clip=None)
    p = jax.device_get(jwalk.init_quantized(jax.random.PRNGKey(0), jc, dtype=jnp.float32,
                                            **fmt)) if fmt else \
        jax.device_get(jwalk.init(jax.random.PRNGKey(0), jc))
    t = from_numpy_tree(p, "cpu")
    tc = tcfg.tiny_config()
    for llm_cfg_j, llm_cfg_t in ((jc.llm, tc.llm),
                                 (dataclasses.replace(jc.llm, norm="layernorm"),
                                  dataclasses.replace(tc.llm, norm="layernorm")),
                                 (dataclasses.replace(jc.llm, head_dim_value=8),
                                  dataclasses.replace(tc.llm, head_dim_value=8))):
        for lj, lt in zip(p["llm"]["layers"], t["llm"]["layers"]):
            assert tfl.layer_tail_supported(lt, llm_cfg_t) == jfl.layer_tail_supported(
                lj, llm_cfg_j)
    want = bool(fmt.get("act_quant") and fmt.get("mlp_int4") and not fmt.get("attn_int4_proj"))
    assert tfl.layer_tail_supported(t["llm"]["layers"][0], tc.llm) == want


def _configs(seg=300):
    jc = jcfg.tiny_config(seg_token_id=seg).replace(clip=None, kv_quant_cache="int4_flat",
                                                     use_flash_attention=True)
    tc = tcfg.tiny_config(seg_token_id=seg).replace(kv_quant_cache="int4_flat",
                                                    use_flash_attention=True)
    wide = dict(hidden_size=128, intermediate_size=384)
    return (jc.replace(llm=dataclasses.replace(jc.llm, **wide)),
            tc.replace(llm=dataclasses.replace(tc.llm, **wide)))


INT4X = dict(act_quant=True, sam_int8=True, mlp_int4=True, attn_int4=True, head_int4=True)


def test_generate_and_segment_fused_layer_matches_jax(monkeypatch):
    jc, tc = _configs()
    p = jax.device_get(jwalk.init_quantized(jax.random.PRNGKey(0), jc, dtype=jnp.float32,
                                            **INT4X))
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200                  # <image> sentinels
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False                                        # ragged prompt rows
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    pt = from_numpy_tree(p, "cpu")
    n_new = 7
    # [SEG]: the token a probe run emits most after its first row, so masks run
    probe = twalk.generate_and_segment(pt, tc, max_new_tokens=n_new, max_segs=8, eos_id=-1,
                                       fused_layer=True, device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe[1:], return_counts=True)
    jc, tc = _configs(int(vals[np.argmax(counts)]))

    traced = []

    def spy(*a, _fn=jfl.fused_layer_tail, **k):
        traced.append(1)
        return _fn(*a, **k)
    monkeypatch.setattr(jfl, "FUSED_LAYER", True)
    monkeypatch.setattr(jfl, "fused_layer_tail", spy)
    jax.clear_caches()                    # no decode step traced without the flag is reused
    want = jwalk.generate_and_segment(
        jax.tree_util.tree_map(jnp.asarray, p), jc, max_new_tokens=n_new, max_segs=8,
        eos_id=-1, **{k: jnp.asarray(v) for k, v in inputs.items()})
    assert traced, "JAX did not take the fused branch"
    jax.clear_caches()

    calls = {"fused_layer_tail": 0, "decode_attention_q": 0, "fused_mlp_int4": 0}
    for mod, name in ((tllm, "fused_layer_tail"), (tllm, "decode_attention_q"),
                      (tint4, "fused_mlp_int4")):
        def tspy(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, tspy)
    got = twalk.generate_and_segment(pt, tc, max_new_tokens=n_new, max_segs=8, eos_id=-1,
                                     fused_layer=True, device="cpu", **inputs)
    assert calls == {"fused_layer_tail": tc.llm.num_layers * n_new, "decode_attention_q": 0,
                     "fused_mlp_int4": 0}, calls
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any()
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.mask_scores.numpy(), np.asarray(want.mask_scores),
                               atol=1e-4, rtol=0)
