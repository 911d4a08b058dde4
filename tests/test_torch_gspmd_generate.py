"""The GSPMD leg of sharded inference (walkgpt_tpu_torch/parallel/infer.py
make_sharded_generate and make_sharded_forward, parallel/gspmd.py) on the
CPU at tiny_config in fp32, in one launch of dp 2 x tp 2 gloo ranks
(parallel/dist.launch; each a process of its own that imports no JAX), on 8
rows over 4 images with row_image_idx = arange(8) % 4, so that every dp
shard's rows read images the other shard encodes:

  * against JAX's make_sharded_generate at dp 2 x tp 2 on 4 of the
    conftest's CPU devices: dense weights over the fp32 heads cache, and
    the int4x format over int4_flat; and the teacher pass with
    device_mask_counts against the JAX CLI's mesh fwd (evaluate._jit_caches);
  * against the port's single device (which earlier slices hold to JAX,
    and JAX's gate holds its GSPMD leg to one device): speculative_k=8 over
    int8_flat, the CLIP stream with dense and with int4x weights (W8A8
    activations), WalkGPT on MPT_TINY (ALiBi, tied head, which the manual
    leg refuses), and the stacked SAM layout of --sam_scan.

Held: tokens, lengths, seg_valid and seg_rows identical, the valid slots'
masks within MASK_TOL (JAX's own gate's rtol / atol); each rank's weight
bytes are what param_pspecs gives; no rank imports JAX; and a batch whose
images or rows dp does not divide raises ValueError before any work."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.parallel import infer as jinfer
from walkgpt_tpu.runtime import evaluate as jev
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.models import sam_encoder, walkgpt as twalk
from walkgpt_tpu_torch.parallel import infer, sharding

GEN = dict(max_new_tokens=6, max_segs=8, eos_id=2)
INT4X = dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)
# JAX's own gate (tests/test_infer_sharded.py:79)
MASK_TOL = 1e-4
LAUNCH = dict(device="cpu", timeout=120, deadline=300)
# tests/test_llm.py's MPT_TINY
MPT_TINY = tcfg.LLMConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=4, pos_emb="alibi", norm="layernorm",
                          act="gelu", tie_embeddings=True, family="mpt")


def _inputs(cfg, b=4, r=8, t=12):
    """8 rows over 4 images (row_image_idx = arange(8) % 4), the sentinel
    at 3, ids below MPT_TINY's vocabulary; the CLIP pixels and their valid
    sizes after."""
    rng = np.random.RandomState(0)
    s, sc = cfg.sam.img_size, cfg.clip.image_size
    ids = np.full((r, t), 5, np.int32)
    ids[:, 0] = 1
    ids[:, 3] = -200
    ids[:, 5:] = rng.randint(3, 120, size=(r, t - 5))
    return (rng.randn(b, s, s, 3).astype(np.float32), ids, np.ones((r, t), bool),
            np.arange(r, dtype=np.int32) % b, np.full((b, 2), s, np.int32),
            rng.randn(b, sc, sc, 3).astype(np.float32),
            np.array([[sc, sc], [sc, sc - 7], [sc - 14, sc], [sc, sc]], np.int32))


def _forward_inputs(cfg, seg):
    """tests/test_torch_tp_generate's teacher-pass layout: image 0 with two
    rounds, three padding rows at the end."""
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


def _single(tree, cfg, x, stream="sam", **kw):
    clip = dict(images_clip=x[5], clip_resize_hw=x[6]) if stream == "clip" else {}
    return twalk.generate_and_segment(tree, cfg, images=x[0], input_ids=x[1],
                                      attention_mask=x[2], row_image_idx=x[3], pixel_hw=x[4],
                                      visual_stream=stream, device="cpu", **clip,
                                      **{**GEN, **kw})


def _with_seg(tree, cfg, x, stream="sam", **kw):
    """cfg with the [SEG] id its single-device run emits most."""
    vals, counts = torch.unique(_single(tree, cfg, x, stream, **kw).tokens, return_counts=True)
    return cfg.replace(seg_token_id=int(vals[counts.argmax()]))


def _mesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))


def _jax_generate(jtree, jc, x):
    mesh = _mesh(2, 2)
    fn = jinfer.make_sharded_generate(mesh, jc, **GEN)
    return fn(jinfer.shard_params(jtree, mesh), *(jnp.asarray(a) for a in x[:5]))


@pytest.fixture(scope="module")
def cases():
    """{name: (port output, reference)}, every case in one launch, and the
    launch's ranks with the whole trees of its jobs."""
    x = _inputs(tcfg.tiny_config())
    jobs, refs = [], {}

    def job(name, cfg, tree, kw=None, stream="sam"):
        kw = dict(GEN, **(kw or {}), **({"visual_stream": stream} if stream != "sam" else {}))
        jobs.append((name, infer.Job(cfg, tree, [("sharded_generate",
                                                  x if stream == "clip" else x[:5], kw)],
                                     layout="gspmd")))

    # dense over the fp32 heads cache and int4x over int4_flat, against JAX
    jd = jcfg.tiny_config()
    dense = jax.device_get(jwalk.init(jax.random.PRNGKey(3), jd))
    td = _with_seg(from_numpy_tree(dense, "cpu"), tcfg.tiny_config(), x)
    refs["dense_heads_vs_jax"] = _jax_generate(dense, jd.replace(seg_token_id=td.seg_token_id),
                                               x)
    job("dense_heads_vs_jax", td, dense)
    jq = jcfg.tiny_config().replace(kv_quant_cache="int4_flat")
    int4x = jax.device_get(jwalk.init_quantized(jax.random.PRNGKey(0), jq, jnp.float32,
                                                **INT4X))
    tq = _with_seg(from_numpy_tree(int4x, "cpu"),
                   tcfg.tiny_config().replace(kv_quant_cache="int4_flat"), x)
    refs["int4x_int4_flat_vs_jax"] = _jax_generate(
        int4x, jq.replace(seg_token_id=tq.seg_token_id), x)
    job("int4x_int4_flat_vs_jax", tq, int4x)

    # the teacher pass, against the JAX CLI's mesh fwd
    xf = _forward_inputs(td, td.seg_token_id)
    mesh = _mesh(2, 2)
    jfwd, _ = jev._jit_caches(jd.replace(seg_token_id=td.seg_token_id), mesh=mesh)
    refs["forward_vs_jax"] = jfwd(8)(jinfer.shard_params(dense, mesh),
                                     *(jnp.asarray(a) for a in xf[:5]),
                                     jnp.asarray(xf[5].astype(np.uint8)), jnp.asarray(xf[6]))
    jobs.append(("forward_vs_jax", infer.Job(td, dense, [("sharded_forward", xf,
                                                          dict(max_segs=8))], layout="gspmd")))

    # against the port's single device
    tree = from_numpy_tree(dense, "cpu")
    ts = _with_seg(tree, tcfg.tiny_config().replace(kv_quant_cache="int8_flat"), x,
                   speculative_k=8)
    refs["speculative_int8_flat"] = _single(tree, ts, x, speculative_k=8)
    job("speculative_int8_flat", ts, dense, dict(speculative_k=8))
    tc = _with_seg(tree, tcfg.tiny_config(), x, "clip")
    refs["clip_stream"] = _single(tree, tc, x, "clip")
    job("clip_stream", tc, dense, stream="clip")
    # the W8A8 activations on the CLIP stream: the tower's split sums round
    # otherwise than one device's, and the LLM's quantizers see it
    tq4 = from_numpy_tree(int4x, "cpu")
    tqc = _with_seg(tq4, tcfg.tiny_config().replace(kv_quant_cache="int4_flat"), x, "clip")
    refs["int4x_clip_stream"] = _single(tq4, tqc, x, "clip")
    job("int4x_clip_stream", tqc, int4x, stream="clip")
    # the stacked SAM layout (--sam_scan): runs of 2 windowed blocks, whose
    # stacked leaves split along the stack axis and the input rows
    sam5 = dataclasses.replace(tcfg.SAM_VIT_TINY, depth=5, global_attn_indexes=(2,))
    t5 = tcfg.tiny_config().replace(sam=sam5)
    blocks = twalk.init(t5, seed=5, device="cpu")
    t5 = _with_seg(blocks, t5, x)
    refs["sam_scan_stacked"] = _single(blocks, t5, x)
    stacked = dict(blocks, sam=dict(blocks["sam"], image_encoder=sam_encoder.stack_for_scan(
        blocks["sam"]["image_encoder"], sam5)))
    job("sam_scan_stacked", t5, stacked)
    base = tcfg.tiny_config()
    tm = base.replace(llm=MPT_TINY)
    mpt = twalk.init(tm, seed=4, device="cpu")
    tm = _with_seg(mpt, tm, x)
    refs["mpt_alibi_tied"] = _single(mpt, tm, x)
    job("mpt_alibi_tied", tm, mpt)

    outs, ranks = infer.run_on_mesh(2, 2, [j for _, j in jobs], **LAUNCH)
    got = {name: o[0] for (name, _), o in zip(jobs, outs)}
    wholes = [j.tree if j.tree is mpt or j.tree is stacked else from_numpy_tree(j.tree, "cpu")
              for _, j in jobs]
    return {name: (got[name], refs[name]) for name in refs}, ranks, wholes


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("case", ["dense_heads_vs_jax", "int4x_int4_flat_vs_jax",
                                  "speculative_int8_flat", "clip_stream", "int4x_clip_stream",
                                  "mpt_alibi_tied", "sam_scan_stacked"])
def test_sharded_generate_identical_tokens_and_segs(cases, case):
    """Tokens, lengths, seg_valid and seg_rows identical to the reference;
    the valid slots' masks and scores within MASK_TOL."""
    got, want = cases[0][case]
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                      err_msg=name)
    sv = _np(want.seg_valid).astype(bool)
    assert sv.any()
    np.testing.assert_allclose(_np(got.pred_masks)[sv], _np(want.pred_masks)[sv],
                               rtol=MASK_TOL, atol=MASK_TOL)
    np.testing.assert_allclose(_np(got.mask_scores)[sv], _np(want.mask_scores)[sv],
                               rtol=MASK_TOL, atol=MASK_TOL)


def test_sharded_forward_matches_the_jax_cli_mesh_pass(cases):
    """make_sharded_forward: seg_valid and seg_rows identical to the JAX
    CLI's mesh fwd, the masks within MASK_TOL, the IoU counts equal, NaN
    losses (the eval reads none)."""
    (got, counts), (want, want_counts) = cases[0]["forward_vs_jax"]
    np.testing.assert_array_equal(_np(got.seg_valid), _np(want.seg_valid))
    np.testing.assert_array_equal(_np(got.seg_rows), _np(want.seg_rows))
    sv = _np(want.seg_valid).astype(bool)
    assert sv.sum() == 8
    np.testing.assert_allclose(_np(got.pred_masks)[sv], _np(want.pred_masks)[sv],
                               rtol=MASK_TOL, atol=MASK_TOL)
    np.testing.assert_array_equal(_np(counts), _np(want_counts))
    assert np.isnan(float(got.loss))


def test_ranks_hold_their_blocks_and_import_no_jax(cases):
    """Each rank's weight bytes per job are param_pspecs' share of the
    whole tree (a split leaf 1/2, the rest whole), below the whole tree's;
    no rank imported jax or walkgpt_tpu; no kernel launch on the CPU."""
    _, ranks, wholes = cases
    for j, whole in enumerate(wholes):
        specs = sharding.param_pspecs(whole, tp=2)
        want = sum(x.numel() * x.element_size() // (2 if "tp" in specs[p] else 1)
                   for p, x in leaves_with_path(whole).items() if torch.is_tensor(x))
        assert [r.value[1][j] for r in ranks] == [want] * 4
        assert want < infer.param_bytes(whole)
    assert all(r.foreign_modules == [] for r in ranks)
    assert all(sum(r.launches.values()) == 0 for r in ranks)


@pytest.mark.parametrize("program", ["generate", "forward"])
def test_batch_that_dp_does_not_divide_raises(program):
    """B or R not a multiple of dp: ValueError before any work (JAX's
    in_shardings refuse it too)."""
    mesh = types.SimpleNamespace(dp=2, tp=1, dp_index=0, tp_index=0,
                                 device=torch.device("cpu"))
    cfg = tcfg.tiny_config()
    s = cfg.sam.img_size
    for b, r in ((3, 4), (4, 3)):
        images, ids = np.zeros((b, s, s, 3), np.float32), np.ones((r, 8), np.int64)
        mask, rii, hw = np.ones((r, 8), bool), np.zeros((r,), np.int64), np.ones((b, 2))
        with pytest.raises(ValueError, match="must each split over dp=2"):
            if program == "generate":
                infer.make_sharded_generate(mesh, cfg, **GEN)({}, images, ids, mask, rii, hw)
            else:
                infer.make_sharded_forward(mesh, cfg, max_segs=8)(
                    {}, images, ids, ids, mask, rii, np.zeros((8, s, s)), hw)
