"""LLM decoder and greedy decode of the PyTorch port against the JAX package
(LLAMA_TINY, fp32, the same parameters and embeddings).

Tolerances: hidden states atol = rtol = 1e-5 in fp32 (same arithmetic,
another summation order); generated tokens and lengths must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.ops.flash_attention import flash_attention as jflash
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.ops.flash_attention import flash_attention as tflash
from walkgpt_tpu_torch.runtime import generate as tgen

TOL = dict(atol=1e-5, rtol=1e-5)
TCFG = tcfg.LLAMA_TINY


@pytest.fixture(scope="module")
def setup():
    p = jax.device_get(jllm.init(jax.random.PRNGKey(2), LLAMA_TINY))
    rng = np.random.RandomState(2)
    emb = rng.randn(3, 13, LLAMA_TINY.hidden_size).astype(np.float32)
    mask = np.arange(13)[None] < np.array([[13], [9], [5]])     # right-padded rows
    return p, from_numpy_tree(p, "cpu"), emb, mask


@pytest.mark.parametrize("flash", [False, True])
def test_forward_right_padded_matches_jax(setup, flash):
    p, pt, emb, mask = setup
    jf = (lambda q, k, v, kv: jflash(q, k, v, True, key_valid=kv)) if flash else None
    tf = (lambda q, k, v, kv: tflash(q, k, v, True, key_valid=kv)) if flash else None
    jcache = jllm.init_kv_cache(LLAMA_TINY, 3, 13)
    want, wcache = jllm.forward(jax.tree_util.tree_map(jnp.asarray, p), LLAMA_TINY,
                                jnp.asarray(emb), attention_mask=jnp.asarray(mask),
                                kv_cache=jcache, flash_fn=jf)
    tcache = tllm.init_kv_cache(TCFG, 3, 13)
    got, tcache = tllm.forward(pt, TCFG, torch.from_numpy(emb),
                               attention_mask=torch.from_numpy(mask), kv_cache=tcache,
                               flash_fn=tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(wcache[name]), **TOL)


def test_decode_step_heads_cache_matches_jax(setup):
    p, pt, emb, mask = setup
    rng = np.random.RandomState(5)
    l_max = 16
    kc = rng.randn(LLAMA_TINY.num_layers, 3, 4, l_max, 16).astype(np.float32)
    vc = rng.randn(*kc.shape).astype(np.float32)
    x = rng.randn(3, 1, 64).astype(np.float32)
    cache_len = np.array([13, 9, 5])
    key_mask = np.arange(l_max)[None] <= cache_len[:, None]
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    for slot in (None, 13):
        want, wc = jllm.decode_step(pj, LLAMA_TINY, {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                    jnp.asarray(x), jnp.asarray(cache_len),
                                    jnp.asarray(key_mask),
                                    write_slot=None if slot is None else jnp.int32(slot))
        got, tc = tllm.decode_step(pt, TCFG, {"k": torch.from_numpy(kc.copy()),
                                              "v": torch.from_numpy(vc.copy())},
                                   torch.from_numpy(x), torch.from_numpy(cache_len),
                                   torch.from_numpy(key_mask), write_slot=slot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(wc["k"]), **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_generate_tokens_identical(setup, flash):
    p, pt, emb, mask = setup
    # eos chosen from the port's own run so one row stops early
    probe = tgen.greedy_generate(pt, TCFG, torch.from_numpy(emb), torch.from_numpy(mask),
                                 max_new_tokens=10, eos_id=-1)
    toks = probe.tokens.numpy()
    cands = [t for t in toks[2, 1:] if t not in toks[0] and t not in toks[1]]
    eos = int(cands[0]) if cands else int(toks[1, 3])
    jf = (lambda q, k, v, kv: jflash(q, k, v, True, key_valid=kv)) if flash else None
    tf = (lambda q, k, v, kv: tflash(q, k, v, True, key_valid=kv)) if flash else None
    want = jgen.greedy_generate(jax.tree_util.tree_map(jnp.asarray, p), LLAMA_TINY,
                                jnp.asarray(emb), jnp.asarray(mask), max_new_tokens=10,
                                eos_id=eos, flash_fn=jf)
    got = tgen.greedy_generate(pt, TCFG, torch.from_numpy(emb), torch.from_numpy(mask),
                               max_new_tokens=10, eos_id=eos, flash_fn=tf)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.lengths.min() < 10 or not cands     # some row stopped at its EOS
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden), **TOL)
    np.testing.assert_allclose(got.prefill_hidden.numpy(), np.asarray(want.prefill_hidden),
                               **TOL)


def test_prefill_chunk_gives_the_same_decode(setup):
    p, pt, emb, mask = setup
    args = (pt, TCFG, torch.from_numpy(emb), torch.from_numpy(mask))
    whole = tgen.greedy_generate(*args, max_new_tokens=6, eos_id=-1)
    chunked = tgen.greedy_generate(*args, max_new_tokens=6, eos_id=-1, prefill_chunk=1)
    assert torch.equal(whole.tokens, chunked.tokens)
    torch.testing.assert_close(whole.pred_hidden, chunked.pred_hidden, atol=1e-5, rtol=1e-5)
