"""The port's manual dp x tp inference (walkgpt_tpu_torch/parallel/tp.py,
parallel/infer.py) on the CPU, in gloo ranks spawned by parallel/dist.launch
(each a process of its own that imports no JAX), at tiny_config in fp32:

  * make_tp_generate at dp 2 x tp 2 in the int4x format over int4_flat, on
    the JAX package's repacked weights, against JAX's make_tp_generate on 4
    of the conftest's CPU devices: tokens, lengths, seg_valid and seg_rows
    identical, masks within MASK_ATOL;
  * make_tp_forward on a layout that needs the row permutation, against
    JAX's make_tp_forward (tests/test_infer_tp.py:207);
  * make_tp_generate against the port's single-device generate_and_segment
    (which earlier slices hold to JAX): dense heads, w8a8 over int8_flat
    (the pmax hook of the row-parallel W8A8 products), speculative_k, GQA,
    and tp = 4 with one kv head a rank;
  * make_dp_generate (dp only) with the "split" and "full" [SEG] budgets.

The ranks are launched three times (dp 2 x tp 2, 1 x 4, 2 x 1), every case
of a layout in one launch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.parallel import tp as jtp
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.parallel import infer

GEN = dict(max_new_tokens=6, max_segs=8, eos_id=2)
INT4X = dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)
# the port and JAX sum the same fp32 products in other orders (XLA's dots)
MASK_ATOL = 1e-4
LAUNCH = dict(device="cpu", timeout=120, deadline=300)


def _inputs(cfg, b=4, t=12):
    """test_infer_tp's batch: 4 images, one row each, the sentinel at 3."""
    rng = np.random.RandomState(0)
    s = cfg.sam.img_size
    ids = np.full((b, t), 5, np.int32)
    ids[:, 0] = 1
    ids[:, 3] = -200
    return (rng.randn(b, s, s, 3).astype(np.float32), ids, np.ones((b, t), bool),
            np.arange(b, dtype=np.int32), np.full((b, 2), s, np.int32))


def _forward_inputs(cfg, seg):
    """test_infer_tp's teacher-pass layout: image 0 with two rounds, three
    padding rows at the end, so the dp split must permute the rows."""
    b, t, s, max_segs = 4, 16, cfg.sam.img_size, 8
    rng = np.random.RandomState(1)
    images = rng.randn(b, s, s, 3).astype(np.float32)
    ids = np.zeros((8, t), np.int32)
    attn = np.zeros((8, t), bool)
    for j in range(5):
        ids[j, :8] = [1, 5, -200, 6, seg, 7, seg, 2]
        attn[j, :8] = True
    ids[5:, 0] = 1
    attn[5:, 0] = True
    rii = np.array([0, 0, 1, 2, 3, 0, 0, 0], np.int32)
    labels = np.full((8, t), -100, np.int32)
    gt = (rng.rand(max_segs, s, s) > 0.5).astype(np.float32)
    return images, ids, labels, attn, rii, gt, np.full((b, 2), s, np.int32)


def _axes(specs):
    """A JAX spec tree as the port's split axes."""
    return jax.tree_util.tree_map(
        lambda s: next((i for i, a in enumerate(tuple(s)) if a == "tp"), None), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))


def _single(tree, cfg, x, **kw):
    return twalk.generate_and_segment(tree, cfg, images=x[0], input_ids=x[1],
                                      attention_mask=x[2], row_image_idx=x[3], pixel_hw=x[4],
                                      device="cpu", **{**GEN, **kw})


def _most_emitted(tree, cfg, x):
    vals, counts = torch.unique(_single(tree, cfg, x).tokens, return_counts=True)
    return int(vals[counts.argmax()])


def _mesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))


@pytest.fixture(scope="module")
def cases():
    """Every case's config, port weights, inputs and references; the three
    launches; {name: (port output, reference, what the reference is)}."""
    out = {}
    x = _inputs(tcfg.tiny_config())

    # int4x over int4_flat on JAX's repacked weights, against JAX's tp program
    jc = jcfg.tiny_config().replace(kv_quant_cache="int4_flat")
    jtree = jax.device_get(jwalk.init_quantized(jax.random.PRNGKey(0), jc, jnp.float32,
                                                **INT4X))
    tc = tcfg.tiny_config().replace(kv_quant_cache="int4_flat")
    seg = _most_emitted(from_numpy_tree(jtree, "cpu"), tc, x)
    jc, tc = jc.replace(seg_token_id=seg), tc.replace(seg_token_id=seg)
    mesh = _mesh(2, 2)
    jparams, jspecs = jtp.repack_params(jtree, jc, mesh)
    jax_int4x = jtp.make_tp_generate(mesh, jc, jspecs, **GEN)(jparams, *x)
    int4x_job = infer.Job(tc, jax.device_get(jparams), [("generate", x, GEN)], _axes(jspecs))

    # dense: lm_head toward [SEG] (test_infer_tp's), generate against the
    # port's single device, the teacher pass against JAX's
    jd = jcfg.tiny_config()
    dtree = jax.device_get(jwalk.init(jax.random.PRNGKey(3), jd, jnp.float32))
    dtree["llm"]["lm_head"]["w"] = np.array(dtree["llm"]["lm_head"]["w"])
    dtree["llm"]["lm_head"]["w"][:, jd.seg_token_id] += 8.0
    td = tcfg.tiny_config()
    xf = _forward_inputs(td, td.seg_token_id)
    jfp, jfs = jtp.repack_params(dtree, jd, mesh)
    jax_fwd = jtp.make_tp_forward(mesh, jd, jfs, max_segs=8)(jfp, *xf)
    dense_job = infer.Job(td, dtree, [("generate", x, GEN), ("forward", xf, dict(max_segs=8))])

    # w8a8 over int8_flat, greedy and speculative; GQA in the int4x format
    tw = tcfg.tiny_config().replace(kv_quant_cache="int8_flat")
    wtree = twalk.init_quantized(tw, seed=0, dtype=torch.float32, device="cpu",
                                 act_quant=True)
    tw = tw.replace(seg_token_id=_most_emitted(wtree, tw, x))
    w8a8_job = infer.Job(tw, wtree, [("generate", x, GEN),
                                     ("generate", x, dict(GEN, speculative_k=4))])
    base = tcfg.tiny_config()
    tg = base.replace(llm=dataclasses.replace(base.llm, num_kv_heads=2),
                      kv_quant_cache="int4_flat")
    gtree = twalk.init_quantized(tg, seed=2, dtype=torch.float32, device="cpu", act_quant=True,
                                 mlp_int4=True, attn_int4=True)
    tg = tg.replace(seg_token_id=_most_emitted(gtree, tg, x))
    gqa_job = infer.Job(tg, gtree, [("generate", x, GEN)])

    (o_int4x, o_dense, o_w8a8, o_gqa), ranks22 = infer.run_on_mesh(
        2, 2, [int4x_job, dense_job, w8a8_job, gqa_job], **LAUNCH)
    out["int4x_vs_jax"] = (o_int4x[0], jax_int4x, "jax")
    out["dense"] = (o_dense[0], _single(dtree_t := from_numpy_tree(dtree, "cpu"), td, x), "port")
    out["forward_vs_jax"] = (o_dense[1], jax_fwd, "jax")
    out["w8a8_int8_flat"] = (o_w8a8[0], _single(wtree, tw, x), "port")
    out["w8a8_speculative"] = (o_w8a8[1], _single(wtree, tw, x, speculative_k=4), "port")
    out["gqa_int4x"] = (o_gqa[0], _single(gtree, tg, x), "port")

    # tp = 4: one kv head a rank (tiny_config has 4), w8a8 over int8_flat
    (o_tp4,), ranks14 = infer.run_on_mesh(1, 4, [infer.Job(tw, wtree, [("generate", x, GEN)])],
                                          **LAUNCH)
    out["tp4_one_kv_head"] = (o_tp4[0], out["w8a8_int8_flat"][1], "port")

    # dp only: the split and the full [SEG] budgets
    dp_kw = dict(GEN, max_segs=24)
    (o_dp,), ranks21 = infer.run_on_mesh(
        2, 1, [infer.Job(td, dtree, [("dp_generate", x, dict(dp_kw, shard_seg_budget="split")),
                                     ("dp_generate", x, dict(dp_kw, shard_seg_budget="full"))])],
        **LAUNCH)
    single24 = _single(dtree_t, td, x, max_segs=24)
    out["dp_split"] = (o_dp[0], single24, "port")
    out["dp_full"] = (o_dp[1], single24, "port")
    out["ranks"] = ranks22 + ranks14 + ranks21
    return out


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _hold_generate(got, want):
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                      err_msg=name)
    sv = _np(want.seg_valid).astype(bool)
    assert sv.any()
    np.testing.assert_allclose(_np(got.pred_masks)[sv], _np(want.pred_masks)[sv], rtol=0,
                               atol=MASK_ATOL)
    np.testing.assert_allclose(_np(got.mask_scores)[sv], _np(want.mask_scores)[sv], rtol=0,
                               atol=MASK_ATOL)


@pytest.mark.parametrize("case", ["int4x_vs_jax", "dense", "w8a8_int8_flat",
                                  "w8a8_speculative", "gqa_int4x", "tp4_one_kv_head",
                                  "dp_full"])
def test_tp_generate_identical_tokens_and_segs(cases, case):
    """Tokens, lengths, seg_valid and seg_rows identical to the reference
    (JAX's tp program, or the port's single device); masks and scores
    within MASK_ATOL."""
    got, want, _ = cases[case]
    _hold_generate(got, want)


def test_tp_forward_teacher_pass_matches_jax(cases):
    """make_tp_forward with the row permutation: seg_valid and seg_rows
    identical to JAX's, NaN losses, masks within MASK_ATOL and the IoU
    counts equal (the masks' signs agree everywhere at this size)."""
    (got, counts), (want, want_counts), _ = cases["forward_vs_jax"]
    np.testing.assert_array_equal(_np(got.seg_valid), _np(want.seg_valid))
    np.testing.assert_array_equal(_np(got.seg_rows), _np(want.seg_rows))
    sv = _np(want.seg_valid).astype(bool)
    assert sv.sum() == 8                      # 5 rows x 2 [SEG]s, capped at max_segs
    np.testing.assert_allclose(_np(got.pred_masks)[sv], _np(want.pred_masks)[sv], rtol=0,
                               atol=MASK_ATOL)
    np.testing.assert_array_equal(_np(counts), _np(want_counts))
    assert np.isnan(float(got.loss)) and np.isnan(float(got.mask_loss))


def test_dp_split_budget_keeps_each_shards_first_segs(cases):
    """"split": each shard extracts max_segs / dp [SEG]s into its own slots;
    with the budget above every shard's count, the valid slots hold the
    single device's [SEG]s in row-major order."""
    got, want, _ = cases["dp_split"]
    np.testing.assert_array_equal(_np(got.tokens), _np(want.tokens))
    gv, wv = _np(got.seg_valid).astype(bool), _np(want.seg_valid).astype(bool)
    assert gv.sum() == wv.sum() > 0
    np.testing.assert_array_equal(_np(got.seg_rows)[gv], _np(want.seg_rows)[wv])
    np.testing.assert_allclose(_np(got.pred_masks)[gv], _np(want.pred_masks)[wv], rtol=0,
                               atol=MASK_ATOL)


def test_ranks_import_no_jax_and_count_no_launch_on_the_cpu(cases):
    """Every spawned rank ran without importing jax or walkgpt_tpu (the test
    process imports both), and on the CPU no kernel counts a launch (the
    wrappers run their plain versions)."""
    ranks = cases["ranks"]
    assert len(ranks) == 4 + 4 + 2
    assert all(r.foreign_modules == [] for r in ranks)
    assert all(sum(r.launches.values()) == 0 for r in ranks)
    assert all(r.peak_bytes == 0 and r.seconds > 0 for r in ranks)
