"""The port's SAM predictor surface against the JAX package's, on the CPU at
SamConfig.for_encoder(SAM_VIT_TINY): the point, box and mask prompts
(models/sam_prompt.py), sam.decode_masks with each prompt kind,
postprocess_masks and ops/resize.nearest_resize, SamPredictor, every AMG
helper and SamAutomaticMaskGenerator (models/sam_predictor.py), the
multi-scale decoder and SAMVisionTower.

Tolerances (fp32): atol = rtol = 1e-5 for embeddings, logits, IoU
predictions and features (the same arithmetic in another summation order;
the port's predictor encodes through the plain versions of K2 and K3, JAX's
through its einsum attention); postprocess_masks within atol = 1e-5 as
well (jax.image.resize forms the interpolation as a product with a weight
matrix, F.interpolate blends the two neighbours: a few ULPs apart);
nearest_resize, binarized masks, boxes, crop boxes, point grids, NMS keeps,
component labels and the AMG records (RLE strings, areas, boxes, stability
scores, points) exactly, the records' predicted IoU within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import sam as jsam
from walkgpt_tpu.models import sam_decoder_multiscale as jmsd
from walkgpt_tpu.models import sam_predictor as jsp
from walkgpt_tpu.models import sam_prompt as jprompt
from walkgpt_tpu.models import sam_tower as jtower
from walkgpt_tpu.ops import resize as jresize
from walkgpt_tpu_torch.core.tree import from_numpy_tree, tree_paths
from walkgpt_tpu_torch.data import transforms as ttransforms
from walkgpt_tpu_torch.models import sam as tsam
from walkgpt_tpu_torch.models import sam_decoder_multiscale as tmsd
from walkgpt_tpu_torch.models import sam_predictor as tsp
from walkgpt_tpu_torch.models import sam_prompt as tprompt
from walkgpt_tpu_torch.models import sam_tower as ttower
from walkgpt_tpu_torch.ops import resize as tresize

TOL = dict(atol=1e-5, rtol=1e-5)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """JAX's SAM at SAM_VIT_TINY, with pos-embed and rel-pos tables filled
    and the mask embedding's layer norms moved off their init so every
    path carries signal; the same tree as torch tensors."""
    cfg = jsam.SamConfig.for_encoder(jcfg.SAM_VIT_TINY)
    p = jax.device_get(jsam.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(3)
    enc = p["image_encoder"]
    enc["pos_embed"] = (0.1 * rng.randn(*enc["pos_embed"].shape)).astype(np.float32)
    for blk in enc["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk[k] = (0.5 * rng.randn(*blk[k].shape)).astype(np.float32)
    for ln in ("ln1", "ln2"):
        md = p["prompt_encoder"]["mask_downscaling"][ln]
        md["scale"] = (1 + 0.2 * rng.randn(*md["scale"].shape)).astype(np.float32)
        md["bias"] = (0.2 * rng.randn(*md["bias"].shape)).astype(np.float32)
    tcfg = tsam.SamConfig.for_encoder(jcfg.SAM_VIT_TINY)
    return cfg, tcfg, p, from_numpy_tree(p, "cpu")


@pytest.mark.parametrize("name", ["vit_h", "vit_l", "vit_b", "tiny"])
def test_sam_config_registry_matches_jax(name):
    if name == "tiny":
        j, t = (m.SamConfig.for_encoder(jcfg.SAM_VIT_TINY, mask_threshold=0.5)
                for m in (jsam, tsam))
    else:
        j, t = getattr(jsam.SamConfig, name)(), getattr(tsam.SamConfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _points(rng, b, n):
    coords = (rng.rand(b, n, 2) * 64).astype(np.float32)
    labels = rng.randint(-1, 2, size=(b, n)).astype(np.int32)
    return coords, labels


@pytest.mark.parametrize("pad", [False, True])
def test_embed_points_matches_jax(tiny, pad):
    cfg, tcfg, p, pt = tiny
    coords, labels = _points(np.random.RandomState(1), 3, 4)
    want = jprompt.embed_points(p["prompt_encoder"], cfg.prompt, jnp.asarray(coords),
                                jnp.asarray(labels), pad)
    got = tprompt.embed_points(pt["prompt_encoder"], tcfg.prompt, torch.from_numpy(coords),
                               torch.from_numpy(labels), pad)
    assert got.shape == (3, 4 + pad, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_boxes_and_masks_match_jax(tiny):
    cfg, tcfg, p, pt = tiny
    rng = np.random.RandomState(2)
    boxes = np.sort(rng.rand(3, 2, 2) * 64, axis=1).transpose(0, 2, 1).reshape(3, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    want = jprompt.embed_boxes(p["prompt_encoder"], cfg.prompt, jnp.asarray(boxes))
    got = tprompt.embed_boxes(pt["prompt_encoder"], tcfg.prompt, torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    masks = (3 * rng.randn(3, 16, 16, 1)).astype(np.float32)
    want = jprompt.embed_masks(p["prompt_encoder"], jnp.asarray(masks))
    got = tprompt.embed_masks(pt["prompt_encoder"], torch.from_numpy(masks))
    assert got.shape == (3, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


PROMPTS = ["points", "boxes", "points+boxes", "masks", "points+masks", "text+points",
           "none"]


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("kinds", PROMPTS)
def test_decode_masks_with_each_prompt_matches_jax(tiny, kinds, multimask):
    """The sparse prompt is [points, boxes, text]; points get the pad token
    only without boxes; masks replace the no-mask dense embedding."""
    cfg, tcfg, p, pt = tiny
    rng = np.random.RandomState(len(kinds))
    b = 1 if kinds == "none" else 3
    feats = rng.randn(1, 4, 4, 32).astype(np.float32)
    kw = {}
    if "points" in kinds:
        kw["points"] = _points(rng, b, 2)
    if "boxes" in kinds:
        kw["boxes"] = (np.array([[4, 6, 40, 50]] * b) + rng.rand(b, 4)).astype(np.float32)
    if "masks" in kinds:
        kw["masks"] = rng.randn(b, 16, 16, 1).astype(np.float32)
    if "text" in kinds:
        kw["text_embeds"] = rng.randn(b, 1, 32).astype(np.float32)
    conv = lambda f: {k: tuple(f(x) for x in v) if isinstance(v, tuple) else f(v)
                      for k, v in kw.items()}
    wm, wi = jsam.decode_masks(_jnp(p), cfg, jnp.asarray(feats), multimask_output=multimask,
                               **conv(jnp.asarray))
    gm, gi = tsam.decode_masks(pt, tcfg, torch.from_numpy(feats), multimask_output=multimask,
                               **conv(torch.from_numpy))
    assert gm.shape == wm.shape == (b, 3 if multimask else 1, 16, 16)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **TOL)


@pytest.mark.parametrize("img,input_size,original", [
    (64, (48, 64), (48, 64)), (64, (64, 44), (93, 64)), (64, (64, 64), (100, 100)),
    (1024, (768, 1024), (480, 640))])
def test_postprocess_masks_matches_jax(img, input_size, original):
    m = np.random.RandomState(img).randn(2, 3, img // 4, img // 4).astype(np.float32)
    want = jsam.postprocess_masks(jnp.asarray(m), img_size=img, input_size=input_size,
                                  original_size=original)
    got = tsam.postprocess_masks(torch.from_numpy(m), img_size=img, input_size=input_size,
                                 original_size=original)
    assert got.shape == (2, 3, *original)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size_in,size_out", [((37, 53), (100, 7)), ((16, 16), (64, 64)),
                                              ((480, 640), (1024, 999)), ((7, 5), (3, 2))])
def test_nearest_resize_bit_for_bit(size_in, size_out):
    x = np.random.RandomState(0).randn(2, *size_in).astype(np.float32)
    want = jresize.nearest_resize(jnp.asarray(x), size_out)
    got = tresize.nearest_resize(torch.from_numpy(x), size_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resize_longest_side_at_equal_size_is_pils():
    """At its own size the port returns the image unchanged (a copy),
    without PIL: PIL's own result."""
    from PIL import Image
    img = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    got = ttransforms.resize_longest_side(img, 64)
    pil = np.array(Image.fromarray(img).resize((64, 48), Image.BILINEAR))
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, img)
    assert got is not img


@pytest.fixture(scope="module")
def predictors(tiny):
    cfg, tcfg, p, pt = tiny
    img = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    jp = jsp.SamPredictor(_jnp(p), cfg)
    tp = tsp.SamPredictor(pt, tcfg, device="cpu")
    jp.set_image(img)
    tp.set_image(img)
    return jp, tp


MODES = {
    "point": dict(point_coords=np.array([[32.0, 24.0]]), point_labels=np.array([1])),
    "points": dict(point_coords=np.array([[32.0, 24.0], [5.0, 40.0]]),
                   point_labels=np.array([1, 0])),
    "box": dict(box=np.array([5.0, 5.0, 40.0, 30.0])),
    "point+box": dict(point_coords=np.array([[20.0, 20.0]]), point_labels=np.array([1]),
                      box=np.array([5.0, 5.0, 40.0, 30.0])),
}


def test_set_image_matches_jax(predictors):
    jp, tp = predictors
    assert tp.input_size == jp.input_size and tp.original_size == jp.original_size
    np.testing.assert_allclose(tp.features.numpy(), np.asarray(jp.features), **TOL)


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("mode", list(MODES) + ["mask_input"])
def test_predict_matches_jax(predictors, mode, multimask, logits):
    jp, tp = predictors
    if mode == "mask_input":
        _, _, low = jp.predict(**MODES["point"], multimask_output=False)
        kw = dict(MODES["point"], mask_input=np.asarray(low[0]))
    else:
        kw = MODES[mode]
    want = jp.predict(multimask_output=multimask, return_logits=logits, **kw)
    got = tp.predict(multimask_output=multimask, return_logits=logits, **kw)
    t = 3 if multimask else 1
    assert got[0].shape == (t, 48, 64) and got[1].shape == (t,) and got[2].shape == (t, 16, 16)
    if logits:
        np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    else:
        assert got[0].dtype == bool
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **TOL)


def test_point_grids_and_crop_boxes_match_jax():
    for n, layers, scale in ((4, 0, 1), (8, 2, 2), (5, 1, 3)):
        for a, b in zip(tsp.build_all_layer_point_grids(n, layers, scale),
                        jsp.build_all_layer_point_grids(n, layers, scale)):
            np.testing.assert_array_equal(a, b)
    for size, layers, ratio in (((100, 150), 2, 0.2), ((768, 1024), 1, 512 / 1500),
                                ((64, 64), 1, 512 / 1500)):
        assert tsp.generate_crop_boxes(size, layers, ratio) == \
            jsp.generate_crop_boxes(size, layers, ratio)


def test_box_helpers_match_jax():
    rng = np.random.RandomState(4)
    masks = rng.rand(6, 30, 40) > 0.97
    masks[2] = False
    np.testing.assert_array_equal(tsp.batched_mask_to_box(masks), jsp.batched_mask_to_box(masks))
    boxes = np.sort(rng.rand(20, 2, 2) * 60, axis=1).transpose(0, 2, 1).reshape(20, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    scores = rng.rand(20).astype(np.float32)
    for thr in (0.1, 0.5, 0.9):
        assert tsp.box_nms(boxes, scores, thr) == jsp.box_nms(boxes, scores, thr)
    for crop in ([0, 0, 60, 60], [10, 5, 45, 50]):
        np.testing.assert_array_equal(tsp.is_box_near_crop_edge(boxes, crop, [0, 0, 60, 60]),
                                      jsp.is_box_near_crop_edge(boxes, crop, [0, 0, 60, 60]))
    logits = (3 * rng.randn(5, 12, 9)).astype(np.float32)
    np.testing.assert_array_equal(tsp.calculate_stability_score(logits, 0.0, 1.0),
                                  jsp.calculate_stability_score(logits, 0.0, 1.0))


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_remove_small_regions_matches_jax_cv2(mode, seed):
    """Random masks of many components (8-connected across diagonals), at
    thresholds that make some, or all, of them small."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(8, 70, size=2)
    mask = rng.rand(h, w) < (0.3 if mode == "islands" else 0.7)
    for thresh in (2, 5, 40, 10 ** 6):
        got, changed = tsp.remove_small_regions(mask, thresh, mode)
        want, jchanged = jsp.remove_small_regions(mask, thresh, mode)
        assert changed == jchanged
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["row", "block", "column", "diagonal"])
def test_remove_small_regions_keep_largest_tie_matches_cv2(layout):
    """Every island small: the largest is kept, and of equal largest ones
    the one cv2 numbers first, by its first 2 x 2 block in raster order
    (scipy would number the first pixel first)."""
    m = np.zeros((8, 12), bool)
    if layout == "row":          # same block row, the right one's pixel higher
        m[1, 0:2] = True
        m[0, 6:8] = True
    elif layout == "block":      # one block apart, same row
        m[1, 2] = m[1, 3] = True
        m[0, 8] = m[0, 9] = True
    elif layout == "column":     # two blocks rows apart
        m[5, 0:2] = True
        m[2, 9:11] = True
    else:                        # diagonal pixels join one island
        m[3, 3] = m[4, 4] = True
        m[1, 8:10] = True
        m[6, 0] = True
    got, changed = tsp.remove_small_regions(m, 100, "islands")
    want, jchanged = jsp.remove_small_regions(m, 100, "islands")
    assert changed and jchanged
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["segmentation"] == w["segmentation"]
        for k in ("area", "bbox", "stability_score", "point_coords"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["predicted_iou"], w["predicted_iou"], **TOL)


@pytest.mark.parametrize("crop_layers,min_area,side", [(0, 0, 4), (1, 4, 2), (1, 30, 3)])
def test_amg_generate_matches_jax(tiny, crop_layers, min_area, side):
    """Both thresholds off, so every mask reaches NMS; crop_n_layers=1 adds
    four overlapping crops (re-encoded after the PIL resize), and
    min_mask_region_area > 0 runs the small-region pass."""
    cfg, tcfg, p, pt = tiny
    kw = dict(points_per_side=side, pred_iou_thresh=-1e9, stability_score_thresh=-1e9,
              crop_n_layers=crop_layers, crop_n_points_downscale_factor=2,
              min_mask_region_area=min_area, box_nms_thresh=0.9)
    img = (np.random.RandomState(2).rand(64, 64, 3) * 255).astype(np.uint8)
    want = jsp.SamAutomaticMaskGenerator(_jnp(p), cfg, **kw).generate(img)
    got = tsp.SamAutomaticMaskGenerator(pt, tcfg, device="cpu", **kw).generate(img)
    _same_records(got, want)


def test_amg_thresholds_match_jax(tiny):
    """The stability offset and the IoU and stability thresholds set where
    they keep some of the grid's masks (this random model's logits are
    small: its masks' stability at offset 1 is 0): the same masks kept."""
    cfg, tcfg, p, pt = tiny
    kw = dict(points_per_side=4, pred_iou_thresh=-0.05, stability_score_thresh=0.6,
              stability_score_offset=0.03, box_nms_thresh=0.95)
    img = (np.random.RandomState(5).rand(64, 64, 3) * 255).astype(np.uint8)
    want = jsp.SamAutomaticMaskGenerator(_jnp(p), cfg, **kw).generate(img)
    got = tsp.SamAutomaticMaskGenerator(pt, tcfg, device="cpu", **kw).generate(img)
    _same_records(got, want)


def test_multiscale_decoder_matches_jax_at_both_levels():
    mcfg = jcfg.MaskDecoderConfig(transformer_dim=32, transformer_mlp_dim=64,
                                  transformer_num_heads=2)
    p = jax.device_get(jmsd.init(jax.random.PRNGKey(1), mcfg, image_feature_scale_num=2))
    assert tree_paths(tmsd.init(torch.Generator().manual_seed(0), mcfg,
                                image_feature_scale_num=2)) == tree_paths(p)
    pt = from_numpy_tree(p, "cpu")
    rng = np.random.RandomState(0)
    x = dict(image_embeddings=rng.randn(1, 4, 4, 32), image_pe=rng.randn(1, 4, 4, 32),
             sparse_prompt=rng.randn(3, 2, 32), dense_prompt=rng.randn(3, 4, 4, 32))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    prev = None
    for level, multimask in ((0, False), (1, True), (1, False)):
        extra = {} if prev is None else {"previous_masks": prev}
        wm, wi = jmsd.apply(_jnp(p), mcfg, multimask_output=multimask, level_num=level,
                            **{k: jnp.asarray(v) for k, v in {**x, **extra}.items()})
        gm, gi = tmsd.apply(pt, mcfg, multimask_output=multimask, level_num=level,
                            **{k: torch.from_numpy(np.asarray(v))
                               for k, v in {**x, **extra}.items()})
        side = 16 if level else 8
        assert gm.shape == (3, 4 if multimask else 1, side, side)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **TOL)
        if level == 0:
            prev = np.asarray(wm) + rng.randn(3, 2, 8, 8).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
def test_sam_vision_tower_matches_jax(tiny, use_flash):
    cfg, tcfg, p, pt = tiny
    images = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    want = jtower.SAMVisionTower(_jnp(p["image_encoder"]), cfg.encoder)(jnp.asarray(images))
    tower = ttower.SAMVisionTower(pt["image_encoder"], tcfg.encoder, use_flash=use_flash)
    got = tower(torch.from_numpy(images))
    assert got.grid == want.grid == (4, 4) and tower.num_patches == 16
    assert tower.hidden_size == 32
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens), **TOL)
    np.testing.assert_allclose(got.spatial.numpy(), np.asarray(want.spatial), **TOL)
