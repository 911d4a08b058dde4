"""The LLM families beside LLaMA in the PyTorch port against the JAX package:
MPT (ALiBi, LayerNorm, GELU MLP, tied embeddings) and StableLM (partial
rope 0.5, GQA 4/2, LayerNorm), on the same parameters and embeddings.

Tolerances: fp32 throughout. Hidden states and logits atol = rtol = 1e-5
(the same arithmetic in another summation order); generated tokens and
lengths identical. WalkGPT on the MPT backbone: tokens, lengths and seg rows
identical, mask logits and scores within atol 1e-4 (the end of the whole
pipeline, as in tests/test_torch_walkgpt.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.core.config import LLMConfig
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops.quant import quantize_llm as jquantize_llm
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.runtime import generate as tgen

# tests/test_llm.py's tiny families
MPT_TINY = LLMConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                     num_layers=2, num_heads=4, num_kv_heads=4, pos_emb="alibi",
                     norm="layernorm", act="gelu", tie_embeddings=True,
                     family="mpt")
STABLELM_TINY = LLMConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                          num_layers=2, num_heads=4, num_kv_heads=2,
                          rope_pct=0.5, norm="layernorm", family="stablelm")
# MPT widened so that the int4 weights take the kernels: the fused q/k/v
# (width 384) K5's 128-column tiles, the gelu MLP K6 on decode rows
MPT_INT4 = dataclasses.replace(MPT_TINY, hidden_size=128, intermediate_size=256)
FAMILIES = {"mpt": MPT_TINY, "stablelm": STABLELM_TINY}
TOL = dict(atol=1e-5, rtol=1e-5)


def _tcfg(cfg: LLMConfig) -> tcfg.LLMConfig:
    return tcfg.LLMConfig(**dataclasses.asdict(cfg))


def _jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    emb = rng.randn(2, 9, cfg.hidden_size).astype(np.float32)
    mask = np.arange(9)[None] < np.array([[9], [6]])           # one right-padded row
    return emb, mask


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    cfg = FAMILIES[request.param]
    p = jax.device_get(jllm.init(jax.random.PRNGKey(3), cfg))
    return cfg, p, from_numpy_tree(p, "cpu"), *_inputs(cfg, 3)


@pytest.mark.parametrize("heads", [8, 12])
def test_alibi_slopes_and_bias_match_jax(heads):
    np.testing.assert_array_equal(tllm.alibi_slopes(heads).numpy(),
                                  np.asarray(jllm.alibi_slopes(heads)))
    cfg = dataclasses.replace(MPT_TINY, num_heads=heads, num_kv_heads=heads)
    pos = np.arange(7)
    np.testing.assert_array_equal(
        tllm.alibi_bias(_tcfg(cfg), torch.from_numpy(pos), torch.from_numpy(pos)).numpy(),
        np.asarray(jllm.alibi_bias(cfg, jnp.asarray(pos), jnp.asarray(pos))))


def test_forward_logits_match_jax(family):
    cfg, p, pt, emb, mask = family
    want, _ = jllm.forward(_jtree(p), cfg, jnp.asarray(emb), attention_mask=jnp.asarray(mask))
    got, _ = tllm.forward(pt, _tcfg(cfg), torch.from_numpy(emb),
                          attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tllm.lm_logits(pt, _tcfg(cfg), got).numpy(),
                               np.asarray(jllm.lm_logits(_jtree(p), cfg, want)), **TOL)


@pytest.mark.parametrize("kv", ["", "int8", "int4"])
def test_greedy_tokens_match_jax(family, kv):
    cfg, p, pt, emb, mask = family
    want = jgen.greedy_generate(_jtree(p), cfg, jnp.asarray(emb), jnp.asarray(mask),
                                max_new_tokens=6, eos_id=-1, kv_quant=kv)
    got = tgen.greedy_generate(pt, _tcfg(cfg), torch.from_numpy(emb), torch.from_numpy(mask),
                               max_new_tokens=6, eos_id=-1, kv_quant=kv)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden), **TOL)


def drop_mlp_biases(p):
    """MPT's MLP without biases, as the published MPT-7B has it (the int4
    packs are bias-free; with biases quantize_llm keeps the MLP int8)."""
    for layer in p["layers"]:
        for proj in layer["mlp"].values():
            proj.pop("b", None)
    return p


@pytest.fixture(scope="module")
def mpt_int4():
    p = drop_mlp_biases(jax.device_get(jllm.init(jax.random.PRNGKey(4), MPT_INT4)))
    p = jax.device_get(jquantize_llm(_jtree(p), act_quant=True, mlp_int4=True, attn_int4=True))
    assert "qkv4" in p["layers"][0]["attn"] and "w_p4t" in p["layers"][0]["mlp"]["fc2"]
    return p, from_numpy_tree(p, "cpu"), *_inputs(MPT_INT4, 4)


@pytest.mark.parametrize("kv", ["", "int8", "int4"])
def test_mpt_int4_weights_match_jax_kernels(mpt_int4, kv, monkeypatch):
    """attn_int4 + mlp_int4 (the gelu fc1/fc2 packs, a W8A8 o-proj, the tied
    head): every decode step runs K5 on the fused q/k/v and K6's gelu route
    (plain versions here), JAX's Pallas kernels in interpret mode."""
    p, pt, emb, mask = mpt_int4
    calls = {"int4_matmul_pallas_reference": 0, "fused_mlp_int4_reference": 0}
    for name in calls:
        def spy(*a, _fn=getattr(tint4, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tint4, name, spy)
    want = jgen.greedy_generate(_jtree(p), MPT_INT4, jnp.asarray(emb), jnp.asarray(mask),
                                max_new_tokens=4, eos_id=-1, kv_quant=kv)
    got = tgen.greedy_generate(pt, _tcfg(MPT_INT4), torch.from_numpy(emb),
                               torch.from_numpy(mask), max_new_tokens=4, eos_id=-1,
                               kv_quant=kv)
    assert min(calls.values()) >= 4 * MPT_INT4.num_layers, calls
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden),
                               atol=1e-4, rtol=1e-4)


def _flat_step_args(cfg):
    """A decode step's arguments (numpy): x, cache_len, key_mask over 16 slots."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 1, cfg.hidden_size).astype(np.float32)
    cache_len = np.array([3, 5])
    key_mask = np.arange(16)[None] <= cache_len[:, None]
    return x, cache_len, key_mask


@pytest.mark.parametrize("case", ["speculative", "flat_alibi", "flat_attend_len"])
def test_refusals_match_jax(case):
    """The paths the JAX package itself refuses raise in both packages with
    its messages: speculative chunks under ALiBi, the flat caches under ALiBi,
    attend_len over a flat cache (an assertion in JAX, a ValueError here)."""
    cfg = MPT_TINY if case != "flat_attend_len" else STABLELM_TINY
    p = jax.device_get(jllm.init(jax.random.PRNGKey(1), cfg))
    pt = from_numpy_tree(p, "cpu")
    x, cache_len, key_mask = _flat_step_args(cfg)
    if case == "speculative":
        jc = jllm.init_kv_cache(cfg, 2, 16)
        tc = tllm.init_kv_cache(_tcfg(cfg), 2, 16)
        xs = np.repeat(x, 3, axis=1)
        with pytest.raises(NotImplementedError, match="speculative chunk decode: rope models"):
            jllm.decode_chunk(_jtree(p), cfg, jc, jnp.asarray(xs), jnp.asarray(cache_len))
        with pytest.raises(NotImplementedError, match="speculative chunk decode: rope models"):
            tllm.decode_chunk(pt, _tcfg(cfg), tc, torch.from_numpy(xs),
                              torch.from_numpy(cache_len))
        return
    jc = jllm.init_kv_cache(cfg, 2, 16, quant="int8", layout="flat")
    tc = tllm.init_kv_cache(_tcfg(cfg), 2, 16, quant="int8", layout="flat")
    kw = dict(attend_len=8) if case == "flat_attend_len" else {}
    if case == "flat_alibi":
        msg, jerr, terr = "flat-cache decode supports rope/no-bias models", \
            NotImplementedError, NotImplementedError
    else:
        msg, jerr, terr = "attend_len prefix reads are heads-layout only", \
            AssertionError, ValueError
    with pytest.raises(jerr, match=msg):
        jllm.decode_step(_jtree(p), cfg, jc, jnp.asarray(x), jnp.asarray(cache_len),
                         jnp.asarray(key_mask), **kw)
    with pytest.raises(terr, match=msg):
        tllm.decode_step(pt, _tcfg(cfg), tc, torch.from_numpy(x), torch.from_numpy(cache_len),
                         torch.from_numpy(key_mask), **kw)


def test_walkgpt_on_mpt_matches_jax():
    """tiny_config with MPT_TINY as its LLM (the [SEG] id inside its
    vocabulary of 128) through generate_and_segment on the SAM stream."""
    jc0 = jcfg.tiny_config().replace(llm=MPT_TINY, clip=None)
    p = jax.device_get(jwalk.init(jax.random.PRNGKey(6), jc0))
    pt = from_numpy_tree(p, "cpu")
    rng = np.random.RandomState(6)
    ids = rng.randint(3, MPT_TINY.vocab_size, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200                  # <image> sentinels
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    tc0 = tcfg.tiny_config().replace(llm=_tcfg(MPT_TINY))
    probe = twalk.generate_and_segment(pt, tc0, max_new_tokens=8, max_segs=8, eos_id=-1,
                                       device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe, return_counts=True)
    seg = int(vals[np.argmax(counts)])
    want = jwalk.generate_and_segment(_jtree(p), jc0.replace(seg_token_id=seg),
                                      max_new_tokens=8, max_segs=8, eos_id=-1,
                                      **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = twalk.generate_and_segment(pt, tc0.replace(seg_token_id=seg), max_new_tokens=8,
                                     max_segs=8, eos_id=-1, device="cpu", **inputs)
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any()
    for name in ("pred_masks", "mask_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
