"""The port's continuous-batching server (runtime/serving.py) against the
JAX package's ContinuousBatcher on the same bridged weights, and the
copied text modules (data/conversation.py, data/tokenizer.py) against
JAX's.

Both batchers run the same arithmetic in fp32 on the CPU (JAX's flat-cache
kernels in interpret mode, the port's plain versions), so the Finished
records must agree exactly in order, request ids and tokens; the [SEG]
hidden states within atol 1e-5 (the same fp32 products summed in another
order). The [SEG] pipeline at tiny_config (splice, batcher, CTP,
sam.decode_masks) takes the slice tests' mask tolerance, atol 1e-4
(tests/test_torch_walkgpt.py). Each JAX batcher compiles its two programs
once per module and serves every case of its pool format."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.data import conversation as jconv
from walkgpt_tpu.data import tokenizer as jtok
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import sam as jsam
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.models.projectors import ctp_apply as jctp_apply
from walkgpt_tpu.runtime import serving as jserving
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.data import conversation as tconv
from walkgpt_tpu_torch.data import tokenizer as ttok
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import sam as tsam
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.models.projectors import ctp_apply as tctp_apply
from walkgpt_tpu_torch.runtime import generate as tgen
from walkgpt_tpu_torch.runtime import serving as tserving

POOLS = ["", "int8", "int8_flat", "int4_flat"]
# 3 slots, prompts bucketed to 16, up to 12 new tokens in segments of 4;
# every token past the specials counts as [SEG], so every step's hidden
# state is harvested and compared
KW = dict(batch_size=3, prompt_len=16, max_new_tokens=12, segment=4, eos_id=2,
          max_segs_per_answer=8)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model():
    p = jax.device_get(jllm.init(jax.random.PRNGKey(0), jcfg.LLAMA_TINY))
    seg = tuple(range(3, jcfg.LLAMA_TINY.vocab_size))
    return p, _j(p), from_numpy_tree(p, "cpu"), seg


@pytest.fixture(scope="module")
def batchers(model):
    """kv -> (JAX batcher, port batcher), built once for the module."""
    _, pj, pt, seg = model
    return {kv: (jserving.ContinuousBatcher(pj, jcfg.LLAMA_TINY, seg_token_ids=seg,
                                            kv_quant=kv, **KW),
                 tserving.ContinuousBatcher(pt, tcfg.LLAMA_TINY, seg_token_ids=seg,
                                            kv_quant=kv, device="cpu", **KW))
            for kv in POOLS}


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 500, n).tolist() for n in lengths]


def _same_finished(got, want):
    assert [f.request_id for f in got] == [f.request_id for f in want]   # completion order
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.request_id, g.tokens, w.tokens)
        w_hid = np.asarray(w.seg_hidden, np.float32)
        assert g.seg_hidden.dtype == np.float32 and g.seg_hidden.shape == w_hid.shape
        np.testing.assert_allclose(g.seg_hidden, w_hid, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["budgets", "fewer_than_slots", "default_budget"])
@pytest.mark.parametrize("kv", POOLS)
def test_batcher_matches_jax(model, batchers, kv, case):
    """Seven requests through three slots with per-request budgets (refills
    mid-stream), two requests in three slots, and four at the default
    budget: the port's Finished records are JAX's."""
    jb, tb = batchers[kv]
    if case == "budgets":
        prompts, budgets = _prompts(1, (6, 9, 7, 16, 3, 12, 5)), [3, 12, 5, 7, 12, 9, 4]
    elif case == "fewer_than_slots":
        prompts, budgets = _prompts(2, (5, 11)), [12, 6]
    else:
        prompts, budgets = _prompts(3, (10, 4, 8, 13)), None
    want = jb.run(iter(prompts), budgets=budgets)
    got = tb.run(iter(prompts), budgets=budgets)
    assert len(got) == len(prompts)
    assert sorted(f.request_id for f in got) == list(range(len(prompts)))
    _same_finished(got, want)
    for f in got:
        assert len(f.tokens) <= (budgets[f.request_id] if budgets else KW["max_new_tokens"])


@pytest.mark.parametrize("kv", POOLS)
def test_batcher_matches_greedy_generate_alone(model, batchers, kv):
    """Each request's tokens equal the port's greedy_generate of that prompt
    alone on the same cache format (tests/test_serving.py's check)."""
    _, _, pt, _ = model
    _, tb = batchers[kv]
    prompts = _prompts(4, (5, 9, 7))
    fins = {f.request_id: f for f in tb.run(prompts)}
    for i, ids in enumerate(prompts):
        x = tllm.embed(pt, torch.tensor([ids]))
        res = tgen.greedy_generate(pt, tcfg.LLAMA_TINY, x, torch.ones((1, len(ids)), dtype=bool),
                                   max_new_tokens=12, eos_id=2, pad_id=0, kv_quant=kv)
        n = int(res.lengths[0])
        assert fins[i].tokens == res.tokens[0, :n].tolist()
        torch.testing.assert_close(torch.from_numpy(fins[i].seg_hidden),
                                   res.pred_hidden[0, :min(n, 8)], atol=2e-4, rtol=2e-4)


def test_batcher_empty_stream(batchers):
    jb, tb = batchers[""]
    assert tb.run(iter([])) == [] == jb.run(iter([]))


def test_rows_past_the_cache_end_match_jax(model):
    """Full-length prompts, a budget that is not a multiple of the segment:
    rows run up to segment - 1 steps past their budget and past the heads
    cache's end (JAX drops those writes, the port writes the row's last
    slot); the kept tokens and hidden states are the same."""
    _, pj, pt, seg = model
    kw = dict(batch_size=2, prompt_len=8, max_new_tokens=10, segment=4, eos_id=-1,
              seg_token_ids=seg, max_segs_per_answer=10)
    prompts = _prompts(5, (8, 8, 8))
    want = jserving.ContinuousBatcher(pj, jcfg.LLAMA_TINY, **kw).run(iter(prompts))
    got = tserving.ContinuousBatcher(pt, tcfg.LLAMA_TINY, device="cpu", **kw).run(prompts)
    assert [len(f.tokens) for f in got] == [10, 10, 10]
    _same_finished(got, want)


def test_batcher_needs_cuda_or_cpu_params(model, monkeypatch):
    _, _, pt, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.ContinuousBatcher(pt, tcfg.LLAMA_TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="device='cpu'"):
        tserving.ContinuousBatcher(pt, tcfg.LLAMA_TINY, device="cuda")


def test_seg_pipeline_matches_jax():
    """tests/test_serving.py:126-162 for the port: spliced visual prompts
    (text from the copied tokenizer), the batcher, Finished.seg_hidden, CTP
    and the SAM mask decoder, against JAX at atol 1e-4. [SEG] is the token
    the batcher emits most (random weights never emit the real one), so
    the mask path runs on real [SEG] states."""
    tok = ttok.ByteTokenizer(model_max_length=2048)
    st = ttok.setup_walkgpt_tokens(tok)
    jc = jcfg.tiny_config(seg_token_id=st.seg_token_idx)
    tc = tcfg.tiny_config(seg_token_id=st.seg_token_idx)
    # the port's init (seconds faster than JAX's at this config), bridged to JAX
    pt = twalk.init(tc, seed=0, device="cpu")
    pj = _j(jax.tree_util.tree_map(lambda x: x.numpy(), pt))
    rng = np.random.RandomState(0)
    images = rng.randn(2, jc.sam.img_size, jc.sam.img_size, 3).astype(np.float32)
    jfeats, jtokens = jax.jit(lambda p, x: jwalk.encode_sam(p, jc, x))(pj, jnp.asarray(images))
    jvis = jax.jit(lambda p, t: jwalk.visual_tokens(p, jc, t))(pj, jtokens)
    jsplice = jax.jit(lambda p, ids, v: jwalk.splice_visual(p, jc, ids, v).embeds[0])
    tfeats, ttokens = twalk.encode_sam(pt, tc, torch.from_numpy(images))
    prompts = [ttok.tokenizer_image_token(t, tok) for t in ("hi <image> what?",
                                                             "<image> where is the curb?")]
    embeds = []
    for i, ids in enumerate(prompts):
        tv = twalk.visual_tokens(pt, tc, ttokens)[i:i + 1]
        je = jsplice(pj, jnp.asarray([ids]), jvis[i:i + 1])
        te = twalk.splice_visual(pt, tc, torch.tensor([ids]), tv).embeds[0]
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=0)
        embeds.append((np.asarray(je), te))
    kw = dict(batch_size=2, prompt_len=80, max_new_tokens=8, segment=4, eos_id=tok.eos_token_id)
    probe = tserving.ContinuousBatcher(pt["llm"], tc.llm, device="cpu", **kw).run(
        [e for _, e in embeds])
    vals, counts = np.unique(np.concatenate([f.tokens for f in probe]), return_counts=True)
    seg = int(vals[np.argmax(counts)])
    want = jserving.ContinuousBatcher(pj["llm"], jc.llm, seg_token_ids=(seg,), **kw).run(
        iter([e for e, _ in embeds] * 2))
    got = tserving.ContinuousBatcher(pt["llm"], tc.llm, seg_token_ids=(seg,), device="cpu",
                                     **kw).run([e for _, e in embeds] * 2)
    _same_finished(got, want)
    assert sum(f.seg_hidden.shape[0] for f in got) > 0
    for g, w in zip(got, want):
        if g.seg_hidden.shape[0] == 0:
            continue
        row = g.request_id % 2                     # the image of the request's prompt
        jemb = jctp_apply(pj["ctp"][0], jnp.asarray(w.seg_hidden))
        temb = tctp_apply(pt["ctp"][0], torch.from_numpy(g.seg_hidden))
        n = temb.shape[0]
        jlow, _ = jsam.decode_masks(pj["sam"], jwalk.sam_config(jc),
                                    jnp.broadcast_to(jfeats[row], (n,) + jfeats.shape[1:]),
                                    text_embeds=jemb[:, None], multimask_output=False)
        tlow, _ = tsam.decode_masks(pt["sam"], twalk.sam_config(tc),
                                    tfeats[row].expand(n, *tfeats.shape[1:]),
                                    text_embeds=temb[:, None], multimask_output=False)
        assert tlow.shape[0] == n and torch.isfinite(tlow).all()
        np.testing.assert_allclose(tlow.numpy(), np.asarray(jlow), atol=1e-4, rtol=0)


QUESTIONS = ["Which nearby features seem pedestrian-friendly, and which could make movement "
             "unsafe?", "Is the crosswalk ahead clear? [SEG]", "Describe the sidewalk surface.",
             "Where is the nearest curb ramp, and how far is it?", "Ünïcödé — obstáculos?"]


@pytest.mark.parametrize("mm_start_end", [True, False])
def test_text_modules_match_jax(mm_start_end):
    """The copied ByteTokenizer, setup_walkgpt_tokens, the llava_v1 template
    and tokenizer_image_token give JAX's ids and prompt strings."""
    toks = []
    for mod in (jtok, ttok):
        tok = mod.build_tokenizer(None, model_max_length=2048)
        st = mod.setup_walkgpt_tokens(tok, use_mm_start_end=mm_start_end)
        toks.append((tok, st))
    (jt, jst), (tt, tst) = toks
    assert (tst.seg_token_idx, tst.im_start_id, tst.im_end_id, tst.extra_ids) == \
        (jst.seg_token_idx, jst.im_start_id, jst.im_end_id, jst.extra_ids)
    assert len(tt) == len(jt)
    for q in QUESTIONS:
        prompts = []
        for conv_lib in (jconv, tconv):
            conv = conv_lib.conv_templates["llava_v1"].copy()
            conv.messages = []
            conv.append_message(conv.roles[0], "<image>\n" + q)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            if mm_start_end:
                prompt = prompt.replace("<image>", "<im_start><image><im_end>")
            prompts.append(prompt)
        assert prompts[0] == prompts[1]
        want = jtok.tokenizer_image_token(prompts[0], jt)
        got = ttok.tokenizer_image_token(prompts[1], tt)
        assert got == want and got.count(tconv.IMAGE_TOKEN_INDEX) == 1
        assert tt.decode(tt.encode(q), skip_special_tokens=True) == q
