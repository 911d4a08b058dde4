"""Speculative decode of the port against the JAX package: the prompt-lookup
proposer, `speculative_generate` over every KV-cache layout it runs on (heads
fp, heads int8 / int4, flat int8 / int4 through the K8 plain version), and
`generate_and_segment(speculative_k=...)` in dense weights and in the two
production formats. JAX's Pallas kernels run in interpret mode.

Tolerances: tokens, lengths, n_iters, [SEG] rows identical; predictor
hidden states at the emitted positions within 2e-4 (the JAX tests' own
limit); masks, scores and CTP embeddings within 1e-4 in fp32
(tests/test_torch_walkgpt.py says why). On the CPU the chunk and the
single-token step run the same arithmetic, so speculative tokens equal the
port's own greedy tokens wherever the JAX tests assert that for JAX."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.runtime import generate as tgen

TCFG = tcfg.LLAMA_TINY
KV = {"heads": "", "int8": "int8", "int4": "int4", "int8_flat": "int8_flat",
      "int4_flat": "int4_flat"}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_result(got, want, hidden_atol=2e-4):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    for b, n in enumerate(np.asarray(want.lengths)):        # emitted positions only
        np.testing.assert_allclose(got.pred_hidden[b, :n].numpy(),
                                   np.asarray(want.pred_hidden)[b, :n],
                                   rtol=hidden_atol, atol=hidden_atol)


def test_ngram_propose_matches_jax():
    rng = np.random.RandomState(0)
    hist = rng.randint(3, 9, size=(4, 40))
    hist[0, :12] = [5, 9, 14] * 4                           # repeats: lookup hits
    hist[2, 30:] = -2                                        # invalid tail
    hlen = np.array([12, 40, 30, 2])
    for ngram, k in ((3, 8), (2, 3), (1, 5)):
        want = jgen._ngram_propose(jnp.asarray(hist, jnp.int32), jnp.asarray(hlen, jnp.int32),
                                   ngram, k)
        got = tgen._ngram_propose(_t(hist), _t(hlen), ngram, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def lookup():
    """LLAMA_TINY, a repetitive prompt (real lookup hits) and a ragged row."""
    p = jax.device_get(jllm.init(jax.random.PRNGKey(7), LLAMA_TINY))
    rng = np.random.RandomState(11)
    base = [5, 9, 14, 5, 9, 14, 5, 9, 14, 5, 9]
    ids = np.stack([base, rng.randint(3, 500, len(base))]).astype(np.int64)
    mask = np.ones_like(ids, bool)
    mask[1, -2:] = False
    x = p["embed_tokens"]["w"][ids]
    pt = from_numpy_tree(p, "cpu")
    greedy = {kind: tgen.greedy_generate(pt, TCFG, _t(x), _t(mask), max_new_tokens=16,
                                         eos_id=2, kv_quant=kv) for kind, kv in KV.items()}
    return p, pt, ids, mask, x, greedy


VARIANTS = {"prompt": lambda ids, mask: {"prompt_ids": np.where(mask, ids, -1)},
            "no_prompt": lambda ids, mask: {},
            "k3_ngram2": lambda ids, mask: {"draft_k": 3, "ngram": 2, "prompt_ids": ids}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", sorted(KV))
def test_speculative_generate_matches_jax(lookup, monkeypatch, kind, variant):
    p, pt, ids, mask, x, greedy = lookup
    kw = VARIANTS[variant](ids, mask)
    want = jgen.speculative_generate(_j(p), LLAMA_TINY, jnp.asarray(x), jnp.asarray(mask),
                                     max_new_tokens=16, eos_id=2, kv_quant=KV[kind],
                                     **{k: jnp.asarray(v) if k == "prompt_ids" else v
                                        for k, v in kw.items()})
    calls = []
    ref = tfa.decode_attention_q_chunk_reference
    monkeypatch.setattr(tfa, "decode_attention_q_chunk_reference",
                        lambda *a, **k: (calls.append(1), ref(*a, **k))[1])
    got = tgen.speculative_generate(pt, TCFG, _t(x), _t(mask), max_new_tokens=16, eos_id=2,
                                    kv_quant=KV[kind],
                                    **{k: _t(v) if k == "prompt_ids" else v
                                       for k, v in kw.items()})
    _same_result(got, want)
    assert got.n_iters == int(want.n_iters) and got.n_iters < 16 + 1
    # K8 (plain here) once per layer and verify iteration over the flat caches
    assert len(calls) == (TCFG.num_layers * got.n_iters if kind.endswith("flat") else 0)
    if kind == "heads" or kind.endswith("flat"):            # as the JAX tests assert
        g = greedy[kind]
        assert torch.equal(got.tokens, g.tokens) and torch.equal(got.lengths, g.lengths)
        for b, n in enumerate(g.lengths.tolist()):
            torch.testing.assert_close(got.pred_hidden[b, :n], g.pred_hidden[b, :n],
                                       atol=2e-4, rtol=2e-4)


def test_speculative_eos_and_budget_match_jax():
    """A vocabulary restricted to EOS and two tokens: EOS inside an accepted
    run stops the row exactly as greedy does."""
    p = jax.device_get(jllm.init(jax.random.PRNGKey(9), LLAMA_TINY))
    pt = from_numpy_tree(p, "cpu")
    ids = np.random.RandomState(3).randint(3, 500, (3, 7))
    mask = np.ones((3, 7), bool)
    x = p["embed_tokens"]["w"][ids]
    lm = np.zeros(LLAMA_TINY.vocab_size, bool)
    lm[[2, 3, 4]] = True
    kw = dict(max_new_tokens=12, eos_id=2)
    want = jgen.speculative_generate(_j(p), LLAMA_TINY, jnp.asarray(x), jnp.asarray(mask),
                                     logits_mask=jnp.asarray(lm), prompt_ids=jnp.asarray(ids),
                                     draft_k=4, **kw)
    got = tgen.speculative_generate(pt, TCFG, _t(x), _t(mask), logits_mask=_t(lm),
                                    prompt_ids=_t(ids), draft_k=4, **kw)
    greedy = tgen.greedy_generate(pt, TCFG, _t(x), _t(mask), logits_mask=_t(lm), **kw)
    want_g = jgen.greedy_generate(_j(p), LLAMA_TINY, jnp.asarray(x), jnp.asarray(mask),
                                  logits_mask=jnp.asarray(lm), **kw)
    _same_result(got, want)
    _same_result(greedy, want_g)
    assert got.n_iters == int(want.n_iters)
    assert torch.equal(got.tokens, greedy.tokens) and torch.equal(got.lengths, greedy.lengths)
    assert got.lengths.min() < 12 and bool(torch.isin(got.tokens, torch.tensor([0, 2, 3, 4])).all())


@pytest.mark.parametrize("kind", ["heads", "int4", "int8_flat"])
@pytest.mark.parametrize("accept", [0, 2, 8])
def test_force_accept_fixes_the_schedule(lookup, monkeypatch, kind, accept):
    """With no EOS in the budget every iteration emits exactly accept + 1
    tokens. The heads layout holds t + 16 slots exactly, so the last chunks
    run past its end: those writes are dropped, as in JAX, without raising."""
    p, pt, ids, mask, x, _ = lookup
    past_end = []
    slots = tllm._chunk_slots

    def spy(cache_len, t, length):
        past_end.append(bool((cache_len + t > length).any()))
        return slots(cache_len, t, length)
    monkeypatch.setattr(tllm, "_chunk_slots", spy)
    kw = dict(max_new_tokens=16, eos_id=-1, force_accept=accept, kv_quant=KV[kind])
    want = jgen.speculative_generate(_j(p), LLAMA_TINY, jnp.asarray(x), jnp.asarray(mask), **kw)
    got = tgen.speculative_generate(pt, TCFG, _t(x), _t(mask), **kw)
    assert got.n_iters == math.ceil(16 / (accept + 1)) == int(want.n_iters)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.lengths.tolist() == [16, 16]
    if kind != "int8_flat":
        assert any(past_end)


def test_oracle_draft_fn_accepts_every_draft(lookup):
    """draft_fn replaces the proposer: drafting the greedy continuation
    itself, every draft is accepted and the tokens stay greedy's."""
    p, pt, ids, mask, x, greedy = lookup
    g = greedy["heads"]
    seen = []

    def oracle(hist, hlen, n_gen):
        seen.append(n_gen.clone())
        idx = (n_gen[:, None] + 1 + torch.arange(8)[None]).clamp_max(15)
        return g.tokens.gather(1, idx)
    got = tgen.speculative_generate(pt, TCFG, _t(x), _t(mask), max_new_tokens=16, eos_id=2,
                                    draft_fn=oracle)
    assert torch.equal(got.tokens, g.tokens) and torch.equal(got.lengths, g.lengths)
    assert got.n_iters == len(seen) <= math.ceil(int(g.lengths.max()) / 9)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

FORMATS = {
    "dense": None,
    "int4_flat": dict(act_quant=True, sam_int8=True, mlp_int4=True, attn_int4=True,
                      head_int4=True),
    "int8_flat": dict(act_quant=True, sam_int8=True),
}
PLAIN_KERNELS = {"dense": (), "int4_flat": ("int4_matmul_pallas_reference",),
                 "int8_flat": ("fused_mlp_int8_reference",)}


def _configs(fmt, seg=300):
    kv = fmt if fmt != "dense" else False
    jc = jcfg.tiny_config(seg_token_id=seg).replace(clip=None, kv_quant_cache=kv,
                                                     use_flash_attention=True)
    tc = tcfg.tiny_config(seg_token_id=seg).replace(kv_quant_cache=kv, use_flash_attention=True)
    if fmt == "dense":
        return jc, tc
    return (jc.replace(llm=dataclasses.replace(jc.llm, hidden_size=128)),
            tc.replace(llm=dataclasses.replace(tc.llm, hidden_size=128)))


@pytest.fixture(scope="module", params=sorted(FORMATS))
def slice_setup(request):
    fmt = request.param
    jc, tc = _configs(fmt)
    key = jax.random.PRNGKey(0)
    p = jax.device_get(jwalk.init(key, jc) if fmt == "dense" else
                       jwalk.init_quantized(key, jc, dtype=jnp.float32, **FORMATS[fmt]))
    # inputs on which no W8A8 code lies on an edge (tests/test_torch_quant_walkgpt.py)
    rng = np.random.RandomState(7)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200                  # <image> sentinels
    ids[0, 5:11] = [7, 8, 9, 7, 8, 9]                          # a repeat for the lookup
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False                                        # ragged prompt rows
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    pt = from_numpy_tree(p, "cpu")
    probe = twalk.generate_and_segment(pt, tc, max_new_tokens=8, max_segs=8, eos_id=-1,
                                       device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe[1:], return_counts=True)
    seg = int(vals[np.argmax(counts)])
    late = [t for t in probe[2, 1:] if t != seg and t not in probe[:2]]
    return fmt, p, pt, inputs, seg, (int(late[0]) if late else -1)


def test_speculative_generate_and_segment_matches_jax(slice_setup, monkeypatch):
    fmt, p, pt, inputs, seg, eos = slice_setup
    jc, tc = _configs(fmt, seg)
    kw = dict(max_new_tokens=8, max_segs=8, eos_id=eos, speculative_k=3)
    want = jwalk.generate_and_segment(_j(p), jc, **kw,
                                      **{k: jnp.asarray(v) for k, v in inputs.items()})
    names = PLAIN_KERNELS[fmt] + (("decode_attention_q_chunk_reference",) if fmt != "dense"
                                  else ())
    calls = dict.fromkeys(names, 0)
    for name in names:
        mod = tfa if name.startswith("decode") else tint4
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _fn(*a, **k))[1])
    got = twalk.generate_and_segment(pt, tc, device="cpu", **kw, **inputs)
    assert all(calls.values()), calls                      # every kernel of the path ran
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any()
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.mask_scores.numpy(), np.asarray(want.mask_scores),
                               atol=1e-4, rtol=0)
    greedy = twalk.generate_and_segment(pt, tc, device="cpu", **{**kw, "speculative_k": 0},
                                        **inputs)
    assert torch.equal(got.tokens, greedy.tokens)


def test_generate_seg_embeds_matches_jax(slice_setup):
    fmt, p, pt, inputs, seg, eos = slice_setup
    jc, tc = _configs(fmt, seg)
    pj = _j(p)
    _, jtok = jwalk.encode_sam(pj, jc, jnp.asarray(inputs["images"]))
    _, ttok = twalk.encode_sam(pt, tc, _t(inputs["images"]))
    args = dict(input_ids=inputs["input_ids"], attention_mask=inputs["attention_mask"],
                row_image_idx=inputs["row_image_idx"])
    for k in (0, 3):
        want = jwalk.generate_seg_embeds(pj, jc, sam_tokens=jtok, max_new_tokens=8, max_segs=8,
                                         eos_id=eos, speculative_k=k,
                                         **{n: jnp.asarray(v) for n, v in args.items()})
        got = twalk.generate_seg_embeds(pt, tc, sam_tokens=ttok, max_new_tokens=8, max_segs=8,
                                        eos_id=eos, speculative_k=k, device="cpu", **args)
        for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_allclose(got.pred_embeddings.numpy(), np.asarray(want.pred_embeddings),
                                   atol=1e-4, rtol=0)
