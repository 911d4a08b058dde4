"""The port's eval metrics (walkgpt_tpu_torch/eval/metrics.py) and the model
pieces the eval entry point adds (core/nn.count_params and cast_tree, the
SAM encoder's `block_runs` layout, generate_and_segment's precomputed_sam)
against the JAX package, on the same numpy inputs from a seed."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.core import nn as jnn
from walkgpt_tpu.eval import metrics as jm
from walkgpt_tpu.models import sam_encoder as jse
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core import nn as tnn
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path, tree_paths
from walkgpt_tpu_torch.eval import metrics as tm
from walkgpt_tpu_torch.models import sam_encoder as tse
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import quant as tquant


def _mask_case(seed, m=6, s=24):
    rng = np.random.RandomState(seed)
    pred = rng.randn(m, s, s).astype(np.float32)
    pred[0, :3] = 0.0                                  # logits exactly 0: background
    gt = (rng.rand(m, s, s) > 0.5).astype(np.float32)
    gt[1, :5, :5] = 255.0                              # ignore region
    gt[2] = 0.0                                        # an empty target
    row_image_idx = np.array([0, 1, 0, 2], np.int64)
    seg_rows = rng.randint(0, 4, size=m).astype(np.int64)
    pixel_hw = np.array([[20, 24], [16, 10], [24, 24]], np.int64)
    return pred, gt, seg_rows, row_image_idx, pixel_hw


@pytest.mark.parametrize("seed", [0, 1])
def test_device_mask_counts_exactly_match_jax(seed):
    """The [M, 3, 2] counts equal JAX's exactly, and the host's
    intersection_and_union on each image's region (ignore rule included)."""
    pred, gt, seg_rows, rows, hw = _mask_case(seed)
    want = np.asarray(jm.device_mask_counts(*(jnp.asarray(x) for x in
                                              (pred, gt, seg_rows, rows, hw))))
    got = tm.device_mask_counts(*(torch.from_numpy(x) for x in (pred, gt, seg_rows, rows, hw)))
    assert got.dtype == torch.float32 and got.shape == (6, 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    gt_u8 = torch.from_numpy(gt.astype(np.uint8))
    got_u8 = tm.device_mask_counts(torch.from_numpy(pred), gt_u8, *(
        torch.from_numpy(x) for x in (seg_rows, rows, hw)))
    assert torch.equal(got_u8, got)
    for k in range(6):
        h, w = hw[rows[seg_rows[k]]]
        inter, union, target = tm.intersection_and_union(
            (pred[k, :h, :w] > 0).astype(np.int64), gt[k, :h, :w].astype(np.int64), 2, 255)
        np.testing.assert_array_equal(got[k].numpy(), np.stack([inter, union, target]))


def _same_results(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


def test_iou_accumulator_and_metric_line_match_jax():
    """Masks through add_mask and counts through add_counts (the no-object,
    FP, FN and TP branches all taken): the same results dict, the same
    metric line; all_reduce keeps the values (one process)."""
    rng = np.random.RandomState(4)
    accs = (jm.IoUAccumulator(), tm.IoUAccumulator())
    cases = [(np.zeros((9, 9)), np.zeros((9, 9))),                    # no object
             (np.ones((9, 9)), np.zeros((9, 9))),                     # FP
             (np.zeros((9, 9)), np.ones((9, 9))),                     # FN
             (np.ones((9, 9)), np.ones((9, 9)))]                      # TP
    cases += [((rng.rand(9, 9) > 0.5), (rng.rand(9, 9) > 0.3)) for _ in range(5)]
    for p, g in cases:
        for acc in accs:
            acc.add_mask(np.asarray(p), np.asarray(g))
    for acc in accs:
        acc.add_counts(np.array([3.0, 4.0]), np.array([5.0, 6.0]), np.array([4.0, 5.0]))
        acc.all_reduce()
    ja, ta = accs[0].results(), accs[1].results()
    _same_results(ja, ta)
    depth = (jm.DepthAccuracy(), tm.DepthAccuracy())
    texts = ["[distance] Distance from the user to the to the bench: 4.5 m; to the pole: "
             "2.5 m. [/distance]", "no block", "[distance] to the curb: 0.2 m [/distance]"]
    gts = [{"bench": 4.0, "pole": 1.0, "curb": 10.0}, {"bench": 1.0}, {"curb": 0.4}]
    for text, gt in zip(texts, gts):
        assert jm.parse_distance_block(text) == tm.parse_distance_block(text)
        for d in depth:
            d.update(text, gt)
    for d in depth:
        d.all_reduce()
    _same_results(depth[0].results(), depth[1].results())
    ja.update(depth[0].results())
    ta.update(depth[1].results())
    from walkgpt_tpu.runtime.evaluate import format_metric_line as jline
    from walkgpt_tpu_torch.runtime.evaluate import format_metric_line as tline
    assert jline("PAVE|val", ja) == tline("PAVE|val", ta)
    assert "depth-acc" in tline("PAVE|val", ta)


def test_average_and_progress_meters_match_jax(capsys):
    out = []
    for m in (jm, tm):
        a = m.AverageMeter("loss", ":.4f")
        b = m.AverageMeter("n", ":.1f", m.Summary.SUM)
        for v, n in ((1.5, 2), (0.25, 1), (3.0, 4)):
            a.update(v, n)
            b.update(v, n)
        a.all_reduce()
        p = m.ProgressMeter(120, [a, b], prefix="Epoch: ")
        p.display(7)
        p.display_summary()
        out.append((str(a), a.summary(), b.summary(), a.avg, capsys.readouterr().out))
    assert out[0] == out[1]


@pytest.mark.parametrize("fmt", ["dense", "int8", "w8a8", "int4x"])
def test_count_params_matches_jax(fmt):
    """The logical count (packed int4 leaves count double) on the same tree
    as JAX's quantize_llm builds it, and cast_tree's dtypes."""
    cfg = jcfg.tiny_config().replace(clip=None)
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, hidden_size=128))
    p = jax.device_get(jwalk.init(jax.random.PRNGKey(3), cfg))
    kw = {"dense": None, "int8": dict(), "w8a8": dict(act_quant=True),
          "int4x": dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)}[fmt]
    tp = from_numpy_tree(p, "cpu")
    if kw is not None:
        p = dict(p, llm=jax.device_get(jquant.quantize_llm(p["llm"], **kw)),
                 sam=jax.device_get(jquant.quantize_sam_encoder(p["sam"])))
        tp = dict(tp, llm=tquant.quantize_llm(tp["llm"], **kw),
                  sam=tquant.quantize_sam_encoder(tp["sam"]))
    assert tnn.count_params(tp) == jnn.count_params(p)
    assert tnn.count_params(from_numpy_tree(p, "cpu")) == jnn.count_params(p)
    jc = jax.device_get(jnn.cast_tree(p, jnp.bfloat16))
    tc = tnn.cast_tree(tp, torch.bfloat16)
    jd = {k: str(np.asarray(v).dtype) for k, v in leaves_with_path(jc).items()
          if not isinstance(v, bool)}
    td = {k: str(v.dtype).replace("torch.", "") for k, v in leaves_with_path(tc).items()
          if isinstance(v, torch.Tensor)}
    assert jd == td


@pytest.mark.parametrize("fmt", ["dense", "int8", "w8a8"])
def test_block_runs_equal_blocks(fmt):
    """stack_for_scan's layout (runs of windowed blocks stacked; the JAX
    layout's paths and shapes for a dense tree) gives the `blocks` layout's
    features bit for bit, plain and quantized blocks alike, on the einsum
    path and the kernels' plain versions."""
    cfg = dataclasses.replace(jcfg.SAM_VIT_TINY, depth=5, global_attn_indexes=(1, 4))
    jp = jax.device_get(jse.init(jax.random.PRNGKey(5), cfg))
    tc = tcfg.SAMEncoderConfig(**dataclasses.asdict(cfg))
    assert tse._scan_plan(tc) == jse._scan_plan(cfg) == [(2, 1), (0, 1), (2, 2), (0, 1)]
    tp = from_numpy_tree(jp, "cpu")
    if fmt == "dense":
        assert (tree_paths(tse.stack_for_scan(tp, tc))
                == tree_paths(from_numpy_tree(jax.device_get(jse.stack_for_scan(jp, cfg)),
                                              "cpu")))
    else:
        tp = tquant.quantize_sam_encoder({"image_encoder": tp},
                                         act_quant=fmt == "w8a8")["image_encoder"]
    stacked = tse.stack_for_scan(tp, tc)
    assert "blocks" not in stacked and len(stacked["block_runs"]) == 4
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32))
    for flash in (False, True):
        a = tse.apply(tp, tc, x, use_flash=flash)
        b = tse.apply(stacked, tc, x, use_flash=flash)
        assert torch.equal(a, b)
    if fmt == "dense":
        want = np.asarray(jse.apply(jp, cfg, jnp.asarray(x.numpy())))
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="another config"):
        tse.apply(stacked, dataclasses.replace(tc, global_attn_indexes=(2,)), x)


def test_generate_and_segment_precomputed_sam():
    """precomputed_sam=(feats, sam_tokens) from encode_sam gives the same
    output as the encode inside, and does not read images."""
    cfg = tcfg.tiny_config()
    p = twalk.init(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(2)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    ids = rng.randint(3, 300, size=(3, 10))
    ids[:, 1] = -200
    kw = dict(input_ids=ids, attention_mask=np.ones((3, 10), bool),
              row_image_idx=np.array([0, 1, 1]), pixel_hw=np.array([[64, 64], [48, 64]]),
              max_new_tokens=6, max_segs=8, eos_id=-1, device="cpu")
    a = twalk.generate_and_segment(p, cfg, images=images, **kw)
    pre = twalk.encode_sam(p, cfg, torch.from_numpy(images))
    b = twalk.generate_and_segment(p, cfg, images=None, precomputed_sam=pre, **kw)
    for f in ("tokens", "lengths", "pred_masks", "seg_valid", "seg_rows", "mask_scores"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
