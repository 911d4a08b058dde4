"""The port's training step against the JAX package's, on the CPU at
tiny_config: the schedule, the trainable policy and the QLoRA partition,
the LoRA helpers, the QLoRA base converters, model_forward's loss terms,
two train_steps, two qlora_train_steps and one grad_accum=2 cycle, all on
the same bridged parameters and the batch of tests/test_train_sharded.py.

The JAX steps run under jax.jit, once per module (fixtures). The port runs
with its attention kernels' plain versions (use_flash_attention=True: K1
and its backward K1b in the LLM) and with the einsum attention; the JAX
side takes the einsum attention (its K1 path agrees with it to ~2e-7).

Tolerances: losses rtol 1e-5 (fp32; another summation order in every
stage); trainable leaves after two steps rtol 2e-4, atol 2e-6 (the JAX
package's own tolerance between two of its steps, tests/test_qlora.py:88:
Adam divides each gradient by its own magnitude, so an element whose
gradient is near zero moves by a fraction of lr that a last-place change
of the gradient can alter); frozen leaves bit-identical; integer codes of
the converters bit-exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import tiny_config as jax_tiny_config
from walkgpt_tpu.data import conversation as conv_lib
from walkgpt_tpu.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu.parallel import sharding as shd
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import train as jtr
from tests.test_train_sharded import device_batch
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path, tree_paths
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import quant as tquant
from walkgpt_tpu_torch.runtime import lora as tlora
from walkgpt_tpu_torch.runtime import train as ttr

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
LEAF_TOL = dict(rtol=2e-4, atol=2e-6)
STEP_CFG = dict(warmup_steps=1, total_steps=10)


def _jflat(tree):
    return {shd._path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in leaves_with_path(tree).items()}


@pytest.fixture(scope="module")
def setup():
    """JAX tiny_config (no CLIP tower) with r=4 LoRA on q/v, its numpy tree,
    the batch as numpy arrays, and the matching port config."""
    conv_lib.set_default_conversation("llava_v1")
    tok = ByteTokenizer(model_max_length=2048)
    st = setup_walkgpt_tokens(tok)
    jcfg = jax_tiny_config(seg_token_id=st.seg_token_idx).replace(clip=None)
    params = jwalk.init(jax.random.PRNGKey(0), jcfg)
    params["llm"] = jck.init_lora(params["llm"], jax.random.PRNGKey(7), r=4, alpha=8.0)
    batch, max_segs = device_batch(tok)
    tc = tcfg.tiny_config(seg_token_id=st.seg_token_idx)
    return dict(jcfg=jcfg, params=params, np_params=jax.device_get(params), batch=batch,
                np_batch={k: np.array(v) for k, v in batch.items()}, max_segs=max_segs,
                tcfg=tc)


def _jax_steps(step_fn, state, batch, n=2):
    out = []
    for _ in range(n):
        state, metrics = step_fn(state, batch)
        out.append((jax.device_get(state.params), {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def jax_dense(setup):
    state, opt = jtr.init_state(setup["params"], jtr.TrainConfig(**STEP_CFG))
    step = jax.jit(functools.partial(jtr.train_step, opt=opt, model_cfg=setup["jcfg"],
                                     max_segs=setup["max_segs"]))
    return _jax_steps(step, state, setup["batch"])


def _qlora_base_jax(params):
    q = dict(params)
    q["llm"] = jquant.quantize_llm(params["llm"], act_quant=False, mlp_int4=True,
                                   quantize_lm_head=False)
    q["sam"] = jquant.quantize_sam_encoder(params["sam"])
    return q


@pytest.fixture(scope="module")
def jax_qlora(setup):
    state, opt, frozen = jtr.init_qlora_state(_qlora_base_jax(setup["params"]),
                                              jtr.TrainConfig(**STEP_CFG))
    step = jax.jit(functools.partial(jtr.qlora_train_step, opt=opt, model_cfg=setup["jcfg"],
                                     max_segs=setup["max_segs"]))
    return _jax_steps(lambda s, b: step(s, frozen, b), state, setup["batch"]), \
        jax.device_get(frozen)


def _port_params(setup):
    return from_numpy_tree(setup["np_params"], "cpu")


def _check_leaves(got: dict, want: dict, label: str):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k], np.float32), **LEAF_TOL,
                                   err_msg=f"{label}: {k}")


# ---------------------------------------------------------------------------
# schedule, policy, partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 110), (1, 10), (0, 5)])
def test_warmup_decay_lr_matches_jax(warmup, total):
    js = jtr.warmup_decay_lr(jtr.TrainConfig(lr=3e-4, warmup_steps=warmup, total_steps=total))
    ts = ttr.warmup_decay_lr(ttr.TrainConfig(lr=3e-4, warmup_steps=warmup, total_steps=total))
    for step in (0, 1, warmup // 2, warmup, (warmup + total) // 2, total, total + 7):
        assert np.float32(ts(step)) == np.float32(js(step)), step
    assert float(ts(0)) == 0.0 or warmup == 0


@pytest.mark.parametrize("kw", [{}, dict(full_finetune=True), dict(tune_projector_only=True),
                                dict(train_mask_decoder=False, train_tiny_xattn=True)])
def test_trainable_mask_matches_jax(setup, kw):
    want = _jflat(jtr.trainable_mask(setup["params"], jtr.TrainConfig(**kw)))
    got = leaves_with_path(ttr.trainable_mask(_port_params(setup), ttr.TrainConfig(**kw)))
    assert got == {k: bool(v) for k, v in want.items()}
    if not kw:      # the reference recipe (tests/test_train_sharded.py:53)
        assert got["llm/embed_tokens/w"] and got["llm/lm_head/w"]
        assert got["llm/layers/0/attn/q/lora_a"] and not got["llm/layers/0/attn/q/lora_scale"]
        assert not any(v for k, v in got.items() if k.startswith("sam/image_encoder"))
        assert all(v for k, v in got.items() if k.startswith(("ctp/", "msqp/")))
        assert not any(v for k, v in got.items() if k.startswith("tiny_xattn"))


def test_partition_combine_roundtrip(setup):
    params = _port_params(setup)
    mask = ttr.trainable_mask(params, ttr.TrainConfig())
    trainable, frozen = ttr.partition_params(params, mask)
    ft, ff, fp = leaves_with_path(trainable), leaves_with_path(frozen), leaves_with_path(params)
    assert set(ft) | set(ff) == set(fp) and not set(ft) & set(ff)
    assert any(k.endswith("lora_a") for k in ft) and any(k.endswith("lora_scale") for k in ff)
    back = leaves_with_path(ttr.combine_params(trainable, frozen))
    assert back.keys() == fp.keys() and all(back[k] is fp[k] for k in fp)
    jt, jf = jtr.partition_params(setup["params"],
                                  jtr.trainable_mask(setup["params"], jtr.TrainConfig()))
    assert set(ft) == set(_jflat(jt)) and set(ff) == set(_jflat(jf))


# ---------------------------------------------------------------------------
# LoRA helpers and the QLoRA base converters
# ---------------------------------------------------------------------------

def _llm_hidden(llm_params, cfg, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, 9, cfg.hidden_size).astype(np.float32))
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[1, 6:] = False
    return tllm.forward(llm_params, cfg, x, attention_mask=mask)[0]


def test_init_lora_layout_and_identity_at_init(setup):
    cfg = setup["tcfg"].llm
    base = twalk.init(setup["tcfg"], seed=1, device="cpu")["llm"]
    g = torch.Generator().manual_seed(0)
    adapted = tlora.init_lora(base, g, r=4, alpha=8.0)
    want = jck.init_lora(jax.device_get(jwalk.init(jax.random.PRNGKey(1), setup["jcfg"]))["llm"],
                         jax.random.PRNGKey(0), r=4, alpha=8.0)
    assert tree_paths(adapted) == tree_paths(jax.device_get(want))
    q = adapted["layers"][0]["attn"]["q"]
    assert q["lora_a"].shape == (cfg.hidden_size, 4) and not q["lora_b"].any()
    assert q["lora_scale"].dtype == torch.float32 and float(q["lora_scale"]) == 2.0
    assert "lora_a" not in base["layers"][0]["attn"]["q"]          # the base tree is untouched
    assert torch.equal(_llm_hidden(adapted, cfg), _llm_hidden(base, cfg))
    # onto a packed int4 base (the QLoRA order): in-width twice the packed rows
    b4 = tquant.quantize_llm(base, mlp_int4=True, attn_int4_proj=True, quantize_lm_head=False)
    a4 = tlora.init_lora(b4, g, r=4)
    q4 = a4["layers"][0]["attn"]["q"]
    assert q4["lora_a"].shape == (2 * q4["w_p4"].shape[0], 4)
    assert q4["lora_a"].dtype == torch.float32


def test_merge_lora_equals_adapter_forward_and_jax(setup):
    cfg = setup["tcfg"].llm
    rng = np.random.RandomState(3)
    np_llm = jax.device_get(setup["np_params"]["llm"])
    for layer in np_llm["layers"]:
        for name in ("q", "v"):
            layer["attn"][name]["lora_b"] = (0.05 * rng.randn(
                *layer["attn"][name]["lora_b"].shape)).astype(np.float32)
    adapted = from_numpy_tree(np_llm, "cpu")
    merged = tlora.merge_lora(adapted)
    assert not any("lora" in k for k in tree_paths(merged))
    torch.testing.assert_close(_llm_hidden(merged, cfg), _llm_hidden(adapted, cfg),
                               atol=1e-5, rtol=1e-5)
    want = _jflat(jck.merge_lora(jax.tree_util.tree_map(jnp.asarray, np_llm)))
    got = _tflat(merged)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-7, rtol=1e-6, err_msg=k)


def test_lora_adapter_tree_and_peft_roundtrip(setup):
    np_llm = setup["np_params"]["llm"]
    adapted = from_numpy_tree(np_llm, "cpu")
    tree = tlora.lora_adapter_tree(adapted)
    assert tree_paths(tree) == tree_paths(jax.device_get(jck.lora_adapter_tree(np_llm)))
    # peft's state-dict layout (lora_A [r, in], lora_B [out, r]) -> extract -> attach
    sd = {}
    for i, layer in enumerate(tree["layers"]):
        for name, slot in layer["attn"].items():
            pre = f"base_model.model.model.layers.{i}.self_attn.{name}_proj"
            sd[f"{pre}.lora_A.default.weight"] = slot["lora_a"].numpy().T
            sd[f"{pre}.lora_B.default.weight"] = slot["lora_b"].numpy().T
    extracted = tlora.extract_lora(sd, alpha=8.0)
    want = jck.extract_lora(sd, alpha=8.0)
    assert extracted.keys() == want.keys()
    back = _tflat(tlora.attach_lora(from_numpy_tree(_strip_lora(np_llm), "cpu"), extracted))
    orig = _tflat(adapted)
    jback = _jflat(jck.attach_lora(jax.tree_util.tree_map(jnp.asarray, _strip_lora(np_llm)),
                                   want))
    assert back.keys() == orig.keys() == jback.keys()
    for k in orig:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(orig[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(back[k]), jback[k], err_msg=k)


def _strip_lora(np_llm):
    """The LLM tree without its adapter leaves."""
    return dict(np_llm, layers=[
        dict(layer, attn={k: {kk: vv for kk, vv in v.items() if not kk.startswith("lora_")}
                          for k, v in layer["attn"].items()}) for layer in np_llm["layers"]])


@pytest.mark.parametrize("kw", [dict(act_quant=False, mlp_int4=True, quantize_lm_head=False),
                                dict(mlp_int4=True, attn_int4_proj=True, quantize_lm_head=False),
                                dict(act_quant=True, quantize_embeddings=True)])
def test_quantize_llm_qlora_options_match_jax(setup, kw):
    np_llm = setup["np_params"]["llm"]
    want = _jflat(jquant.quantize_llm(jax.tree_util.tree_map(jnp.asarray, np_llm), **kw))
    got = _tflat(tquant.quantize_llm(from_numpy_tree(np_llm, "cpu"), **kw))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the training forward and the steps
# ---------------------------------------------------------------------------

def test_splice_labels_seg_mask_and_gather_match_jax(setup):
    b = setup["np_batch"]
    jcfg, tc = setup["jcfg"], setup["tcfg"]
    rng = np.random.RandomState(1)
    vis = rng.randn(2, jcfg.visual_tokens, jcfg.llm.hidden_size).astype(np.float32)
    want = jwalk.splice_visual(setup["params"], jcfg, jnp.asarray(b["input_ids"]),
                               jnp.asarray(vis), attention_mask=jnp.asarray(b["attention_mask"]),
                               labels=jnp.asarray(b["labels"]))
    got = twalk.splice_visual(_port_params(setup), tc, torch.from_numpy(b["input_ids"]).long(),
                              torch.from_numpy(vis), torch.from_numpy(b["attention_mask"]),
                              labels=torch.from_numpy(b["labels"]).long())
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))
    sm = jwalk.seg_timeline_mask(jnp.asarray(b["input_ids"]), jcfg.seg_token_id, jcfg)
    tm = twalk.seg_timeline_mask(torch.from_numpy(b["input_ids"]), tc.seg_token_id, tc)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(sm))
    for size in (1, 3, setup["max_segs"], 40):
        (jidx,) = jnp.nonzero(sm.reshape(-1), size=size, fill_value=0)
        idx, valid = twalk._first_true(tm.reshape(-1), size)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.arange(size) < int(sm.sum()))


def test_model_forward_loss_terms_match_jax(setup, jax_dense):
    """The loss terms of the first JAX step are model_forward's at the
    initial parameters."""
    b = {k: torch.from_numpy(v) for k, v in setup["np_batch"].items()}
    b = twalk._as_inputs("cpu", **b)
    for flash in (False, True):
        out = twalk.model_forward(_port_params(setup),
                                  setup["tcfg"].replace(use_flash_attention=flash),
                                  max_segs=setup["max_segs"], **b)
        for k in ttr.METRICS:
            np.testing.assert_allclose(float(getattr(out, k)), jax_dense[0][1][k], **LOSS_TOL,
                                       err_msg=f"{k} flash={flash}")
        assert int(out.seg_valid.sum()) == 3 and out.pred_masks.shape == (8, 64, 64)


@pytest.mark.parametrize("flash", [False, True])
def test_train_step_matches_jax(setup, jax_dense, flash):
    cfg = setup["tcfg"].replace(use_flash_attention=flash)
    params = _port_params(setup)
    state, opt = ttr.init_state(params, ttr.TrainConfig(**STEP_CFG))
    frozen_before = {k: v.clone() for k, v in leaves_with_path(params).items()
                     if isinstance(v, torch.Tensor) and k not in opt.trainable}
    for i, (want_params, want_metrics) in enumerate(jax_dense):
        state, metrics = ttr.train_step(state, setup["np_batch"], opt=opt, model_cfg=cfg,
                                        max_segs=setup["max_segs"], remat=i == 1,
                                        device="cpu")
        for k in ttr.METRICS:
            np.testing.assert_allclose(float(metrics[k]), want_metrics[k], **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    assert state.step == 2 and state.opt_state["count"] == 2
    got = _tflat(state.params)
    want = _jflat(want_params)
    _check_leaves({k: got[k] for k in opt.trainable}, {k: want[k] for k in opt.trainable},
                  "trainable")
    moved = [k for k in opt.trainable if k.endswith("lora_b") and np.abs(got[k]).max() > 0]
    assert moved, "no lora_b moved after two steps"
    after = leaves_with_path(state.params)
    for k, v in frozen_before.items():
        assert torch.equal(after[k], v), k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_qlora_train_step_matches_jax(setup, jax_qlora):
    runs, jfrozen = jax_qlora
    qparams = dict(_port_params(setup))
    qparams["llm"] = tquant.quantize_llm(qparams["llm"], act_quant=False, mlp_int4=True,
                                         quantize_lm_head=False)
    qparams["sam"] = tquant.quantize_sam_encoder(qparams["sam"])
    state, opt, frozen = ttr.init_qlora_state(qparams, ttr.TrainConfig(**STEP_CFG))
    frozen_before = {k: v.clone() for k, v in leaves_with_path(frozen).items()
                     if isinstance(v, torch.Tensor)}
    assert any(k.endswith("w_p4t") for k in frozen_before)
    for i, (want_params, want_metrics) in enumerate(runs):
        state, metrics = ttr.qlora_train_step(state, frozen, setup["np_batch"], opt=opt,
                                              model_cfg=setup["tcfg"],
                                              max_segs=setup["max_segs"], device="cpu")
        for k in ttr.METRICS:
            np.testing.assert_allclose(float(metrics[k]), want_metrics[k], **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    _check_leaves(_tflat(state.params), _jflat(want_params), "trainable subtree")
    jf = _jflat(jfrozen)
    for k, v in leaves_with_path(frozen).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, frozen_before[k]), k
            np.testing.assert_array_equal(v.numpy(), jf[k], err_msg=k)


def test_grad_accum_matches_multisteps(setup):
    """grad_accum=2 against optax.MultiSteps: nothing moves after the first
    micro-batch; after the second, the update of the mean gradient (the
    recipe's lr, no warmup, so the update is applied in full)."""
    tcj = jtr.TrainConfig(warmup_steps=0, total_steps=10, grad_accum=2)
    jstate, jopt = jtr.init_state(setup["params"], tcj)
    jstep = jax.jit(functools.partial(jtr.train_step, opt=jopt, model_cfg=setup["jcfg"],
                                      max_segs=setup["max_segs"]))
    runs = _jax_steps(jstep, jstate, setup["batch"])
    params = _port_params(setup)
    state, opt = ttr.init_state(params, ttr.TrainConfig(warmup_steps=0, total_steps=10,
                                                         grad_accum=2))
    before = leaves_with_path(params)
    state, _ = ttr.train_step(state, setup["np_batch"], opt=opt, model_cfg=setup["tcfg"],
                              max_segs=setup["max_segs"], device="cpu")
    assert all(v is before[k] for k, v in leaves_with_path(state.params).items())
    assert state.opt_state["mini_step"] == 1 and state.opt_state["count"] == 0
    state, _ = ttr.train_step(state, setup["np_batch"], opt=opt, model_cfg=setup["tcfg"],
                              max_segs=setup["max_segs"], device="cpu")
    assert state.opt_state["mini_step"] == 0 and state.opt_state["count"] == 1
    got, want = _tflat(state.params), _jflat(runs[1][0])
    _check_leaves({k: got[k] for k in opt.trainable}, {k: want[k] for k in opt.trainable},
                  "after two micro-batches")
    init = _tflat(params)
    assert any(np.abs(got[k] - init[k]).max() > 0 for k in opt.trainable)


@pytest.mark.parametrize("kw,match", [
    (dict(act_quant=False), "integer dtype"),
    (dict(act_quant=True, quantize_lm_head=False), "act_quant=False")])
def test_init_qlora_state_guards(setup, kw, match):
    for tr, quantize, params in ((jtr, jquant.quantize_llm, setup["params"]),
                                 (ttr, tquant.quantize_llm, _port_params(setup))):
        bad = dict(params, llm=quantize(params["llm"], **kw))
        with pytest.raises(ValueError, match=match):
            tr.init_qlora_state(bad, tr.TrainConfig())
