"""The growing KV cache (greedy_generate's cache_grow_step, WalkGPTConfig.
decode_cache_grow) of the PyTorch port: segments over one allocation whose
attention reads the prefix T + (k + 1) * step, against the single
allocation and against the JAX package.

Setup of tests/test_llm.py's growing-cache test (LLAMA_TINY, a padded row,
11 new tokens, EOS 2): tokens and lengths identical; hidden states within
that test's own tolerances, atol 1e-5 for the fp cache and 1e-3 for the
int8 one (the sums run over a shorter length; int8 dequantization
amplifies the reassociation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.runtime import generate as tgen

TCFG = tcfg.LLAMA_TINY
ATOL = {"": 1e-5, "int8": 1e-3}


@pytest.fixture(scope="module")
def setup():
    p = jax.device_get(jllm.init(jax.random.PRNGKey(21), LLAMA_TINY))
    rng = np.random.RandomState(21)
    batch = np.zeros((2, 7), np.int64)
    batch[0, :4] = rng.randint(3, LLAMA_TINY.vocab_size, 4)
    batch[1] = rng.randint(3, LLAMA_TINY.vocab_size, 7)
    mask = np.zeros((2, 7), bool)
    mask[0, :4] = True
    mask[1] = True
    x = np.array(jllm.embed(p, jnp.asarray(batch)))
    return p, from_numpy_tree(p, "cpu"), x, mask


def _greedy(pt, x, mask, kv, grow=0):
    return tgen.greedy_generate(pt, TCFG, torch.from_numpy(x), torch.from_numpy(mask),
                                max_new_tokens=11, eos_id=2, kv_quant=kv,
                                cache_grow_step=grow)


@pytest.mark.parametrize("grow", [4, 5, 11])
@pytest.mark.parametrize("kv", ["", "int8"])
def test_grow_matches_single_allocation(setup, kv, grow, monkeypatch):
    """Each segment's steps read the prefix they can attend (11: no
    segmentation, max_new_tokens does not exceed it)."""
    p, pt, x, mask = setup
    base = _greedy(pt, x, mask, kv)
    seen = []

    def spy(*a, _fn=tllm.decode_step, **k):
        seen.append(k.get("attend_len"))
        return _fn(*a, **k)
    monkeypatch.setattr(tllm, "decode_step", spy)
    seg = _greedy(pt, x, mask, kv, grow)
    t = x.shape[1]
    want = [t + min((s // grow + 1) * grow, 11) for s in range(11)] if grow < 11 else [None] * 11
    assert seen == [None if w == t + 11 else w for w in want], seen
    np.testing.assert_array_equal(seg.tokens.numpy(), base.tokens.numpy())
    np.testing.assert_array_equal(seg.lengths.numpy(), base.lengths.numpy())
    np.testing.assert_allclose(seg.pred_hidden.numpy(), base.pred_hidden.numpy(),
                               atol=ATOL[kv], rtol=0)


def test_grow_matches_jax(setup):
    """One grow value against the JAX package's greedy_generate (its own
    growing-cache test is marked slow; this is its one call)."""
    p, pt, x, mask = setup
    want = jgen.greedy_generate(jax.tree_util.tree_map(jnp.asarray, p), LLAMA_TINY,
                                jnp.asarray(x), jnp.asarray(mask), max_new_tokens=11, eos_id=2,
                                cache_grow_step=5)
    got = _greedy(pt, x, mask, "", 5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden),
                               atol=ATOL[""], rtol=0)


def test_decode_cache_grow_through_generate_and_segment():
    """WalkGPTConfig.decode_cache_grow reaches greedy_generate: the tiny
    pipeline gives the tokens and masks of the single allocation."""
    cfg = tcfg.tiny_config()
    pt = twalk.init(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(3)
    ids = rng.randint(1, 500, size=(2, 10))
    ids[:, 2] = -200
    kw = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
              attention_mask=np.ones((2, 10), bool), row_image_idx=np.array([0, 1]),
              pixel_hw=np.array([[64, 64], [64, 48]]), max_new_tokens=9, max_segs=4, eos_id=-1,
              device="cpu")
    base = twalk.generate_and_segment(pt, cfg, **kw)
    grown = twalk.generate_and_segment(pt, cfg.replace(decode_cache_grow=4), **kw)
    np.testing.assert_array_equal(grown.tokens.numpy(), base.tokens.numpy())
    np.testing.assert_allclose(grown.pred_masks.numpy(), base.pred_masks.numpy(),
                               atol=1e-5, rtol=0)
