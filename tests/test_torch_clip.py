"""The CLIP tower and the CLIP stream of the port against the JAX package on
the CPU: models/clip_vit (apply with the token mask, select_features,
resize_pos_embed), checkpoint.convert_clip_vision, walkgpt's
clip_padding_masks, splice_visual's vis_mask, splice_visual_multi,
generate_and_segment(visual_stream="clip") at tiny_config, the whole init
tree with its count_params, and the eval CLI's --visual_stream clip.

The parameters are carried across by from_numpy_tree (the port's init as
numpy, at this size faster than JAX's). Tolerances: the tower's hidden
states in fp32 within atol 2e-5 (2 pre-LN blocks, another summation order
in each product and softmax); the resized position embeddings and the
converter's output within 1e-6 (one bilinear interpolation); masks, splices
and tokens exactly; the CLIP stream's mask logits within 1e-4 (the whole
pipeline, as tests/test_torch_walkgpt.py holds the SAM stream's)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.core import nn as jnn
from walkgpt_tpu.models import clip_vit as jclip
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core import nn as tnn
from walkgpt_tpu_torch.core.tree import (from_numpy_tree, leaves_with_path, map_with_path,
                                         tree_paths)
from walkgpt_tpu_torch.models import clip_vit as tclip
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.runtime import checkpoint as tck

HIDDEN_TOL = dict(rtol=0, atol=2e-5)


def _np(tree):
    return map_with_path(lambda _, x: x.numpy(), tree)


@pytest.fixture(scope="module")
def params():
    """tiny_config's whole tree, numpy; the CLIP position embeddings and the
    class embedding scaled up so that the mask moves the outputs."""
    p = _np(twalk.init(tcfg.tiny_config(), seed=4, device="cpu"))
    rng = np.random.RandomState(1)
    p["clip"]["pos_embed"] = rng.randn(*p["clip"]["pos_embed"].shape).astype(np.float32)
    p["clip"]["class_embed"] = rng.randn(*p["clip"]["class_embed"].shape).astype(np.float32)
    return p


def test_init_tree_and_count_params_match_jax():
    """The port's init has JAX's key paths and shapes, the CLIP tower and
    the mm_projector included, and the same count_params; the CLIP leaves
    come after every other leaf, so the rest keep their values."""
    for factory in ("tiny_config", "demo_config"):
        jc = getattr(jcfg, factory)()
        want = jax.eval_shape(lambda: jwalk.init(jax.random.PRNGKey(0), jc))
        got = twalk.init(getattr(tcfg, factory)(), seed=0, device="cpu")
        assert tree_paths(got) == tree_paths(want)
        assert "clip" in got and "mm_projector" in got
        assert tnn.count_params(got) == jnn.count_params(want)
    no_clip = twalk.init(tcfg.tiny_config().replace(clip=None), seed=3, device="cpu")
    full = twalk.init(tcfg.tiny_config(), seed=3, device="cpu")
    assert set(full) - set(no_clip) == {"clip", "mm_projector"}
    for k in no_clip:
        a, b = leaves_with_path(no_clip[k]), leaves_with_path(full[k])
        assert list(a) == list(b) and all(torch.equal(a[p], b[p]) for p in a), k


@pytest.mark.parametrize("masked", [False, True])
def test_clip_apply_and_select_features_match_jax(params, masked):
    cfg = tcfg.tiny_config().clip
    rng = np.random.RandomState(2)
    images = rng.randn(3, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 1 + cfg.grid * cfg.grid), bool)
        mask[1, 2:] = False
        mask[2, [1, 3]] = False
    want = jclip.apply(jax.tree_util.tree_map(jnp.asarray, params["clip"]), cfg,
                       jnp.asarray(images), attention_mask=None if mask is None else
                       jnp.asarray(mask))
    got = tclip.apply(from_numpy_tree(params["clip"], "cpu"), cfg, torch.from_numpy(images),
                      attention_mask=None if mask is None else torch.from_numpy(mask))
    assert len(got) == len(want) == cfg.num_layers + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **HIDDEN_TOL)
    (tf, ta), (jf, ja) = tclip.select_features(got, cfg), jclip.select_features(want, cfg)
    assert tf.shape == (3, cfg.grid * cfg.grid, cfg.hidden_size)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **HIDDEN_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **HIDDEN_TOL)
    if masked:   # the mask changes the masked image's states
        free = tclip.apply(from_numpy_tree(params["clip"], "cpu"), cfg,
                           torch.from_numpy(images))
        assert not torch.allclose(free[-1][1], got[-1][1])


def _hf_clip_state_dict(rng, c, layers, grid, patch, mlp):
    sd = {"vision_model.embeddings.class_embedding": rng.randn(c),
          "vision_model.embeddings.patch_embedding.weight": rng.randn(c, 3, patch, patch),
          "vision_model.embeddings.position_embedding.weight": rng.randn(1 + grid * grid, c),
          "vision_model.pre_layrnorm.weight": rng.randn(c),
          "vision_model.pre_layrnorm.bias": rng.randn(c)}
    for i in range(layers):
        b = f"vision_model.encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = rng.randn(c), rng.randn(c)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[b + f"self_attn.{n}.weight"] = rng.randn(c, c)
            sd[b + f"self_attn.{n}.bias"] = rng.randn(c)
        sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = rng.randn(mlp, c), rng.randn(mlp)
        sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = rng.randn(c, mlp), rng.randn(c)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("src,dst", [(4, 4), (4, 6), (6, 3)])
def test_resize_pos_embed_and_convert_clip_vision_match_jax(src, dst):
    rng = np.random.RandomState(src * 10 + dst)
    pos = rng.randn(1 + src * src, 8).astype(np.float32)
    np.testing.assert_allclose(tclip.resize_pos_embed(torch.from_numpy(pos), src, dst).numpy(),
                               np.asarray(jclip.resize_pos_embed(jnp.asarray(pos), src, dst)),
                               rtol=0, atol=1e-6)
    sd = _hf_clip_state_dict(rng, 8, 2, src, 2, 16)
    want = jck.convert_clip_vision(sd, num_layers=2, src_grid=src, dst_grid=dst)
    got = tck.convert_clip_vision(sd, num_layers=2, src_grid=src, dst_grid=dst)
    wl, gl = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, w), (_, g) in zip(wl, gl):
        assert np.asarray(g).shape == np.asarray(w).shape, path
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert got["pos_embed"].shape == (1 + dst * dst, 8)
    # the converted tree runs the port's tower at the target grid
    cfg = tcfg.CLIPVisionConfig(image_size=2 * dst, native_image_size=2 * src, patch_size=2,
                                hidden_size=8, num_layers=2, num_heads=2, mlp_dim=16,
                                select_layer=-2, aux_layer=-1)
    out = tclip.apply(from_numpy_tree(got, "cpu"), cfg, torch.zeros(1, 2 * dst, 2 * dst, 3))
    assert out[-1].shape == (1, 1 + dst * dst, 8)


@pytest.mark.parametrize("factory", ["tiny_config", "walkgpt_7b_config"])
def test_clip_padding_masks_match_jax(factory):
    cfg_j, cfg_t = getattr(jcfg, factory)(), getattr(tcfg, factory)()
    s = cfg_t.clip.image_size
    hw = np.array([[s, s], [s, s // 2], [s // 3, s], [1, 5], [s - 13, s - 1]], np.int64)
    jt, jl = jwalk.clip_padding_masks(cfg_j, jnp.asarray(hw))
    tt, tl = twalk.clip_padding_masks(cfg_t, torch.from_numpy(hw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tt.shape == (5, 1 + cfg_t.clip.grid ** 2) and tl.shape == (5, cfg_t.visual_tokens)
    assert tt[0].all() and not tl[3].all()


def test_splice_visual_multi_and_vis_mask_match_jax(params):
    """splice_visual_multi (two sentinels, one, none; labels and a ragged
    mask) and splice_visual with a vis_mask, exactly."""
    cfg_j, cfg_t = jcfg.tiny_config(), tcfg.tiny_config()
    rng = np.random.RandomState(3)
    ids = rng.randint(1, 400, size=(3, 12))
    ids[0, [2, 7]] = -200
    ids[1, 4] = -200
    mask = np.ones((3, 12), bool)
    mask[2, 8:] = False
    labels = np.where(rng.rand(3, 12) > 0.5, ids, -100)
    vis = rng.randn(3, 2, cfg_t.visual_tokens, cfg_t.llm.hidden_size).astype(np.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), from_numpy_tree(params, "cpu")
    want = jwalk.splice_visual_multi(jp, cfg_j, jnp.asarray(ids), jnp.asarray(vis),
                                     attention_mask=jnp.asarray(mask),
                                     labels=jnp.asarray(labels))
    got = twalk.splice_visual_multi(tp, cfg_t, torch.from_numpy(ids), torch.from_numpy(vis),
                                    attention_mask=torch.from_numpy(mask),
                                    labels=torch.from_numpy(labels))
    for name in ("embeds", "attention_mask", "labels", "image_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.embeds.shape[1] == 12 + 2 * (cfg_t.visual_tokens - 1)

    vmask = rng.rand(3, cfg_t.visual_tokens) > 0.3
    want = jwalk.splice_visual(jp, cfg_j, jnp.asarray(ids), jnp.asarray(vis[:, 0]),
                               attention_mask=jnp.asarray(mask), vis_mask=jnp.asarray(vmask))
    got = twalk.splice_visual(tp, cfg_t, torch.from_numpy(ids), torch.from_numpy(vis[:, 0]),
                              attention_mask=torch.from_numpy(mask),
                              vis_mask=torch.from_numpy(vmask))
    for name in ("embeds", "attention_mask", "image_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_generate_and_segment_clip_stream_matches_jax(params):
    """visual_stream="clip" at tiny_config, with padding masks from
    clip_resize_hw: tokens, lengths and [SEG] rows identical to JAX's, the
    masks (decoded against the SAM features) within 1e-4; the stream's
    tokens differ from the SAM stream's."""
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200
    mask = np.ones((3, 12), bool)
    mask[2, 6:] = False
    s = tcfg.tiny_config().clip.image_size
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    clip = dict(images_clip=rng.randn(2, s, s, 3).astype(np.float32),
                clip_resize_hw=np.array([[s, s], [s, s // 2]], np.int64))
    tp = from_numpy_tree(params, "cpu")
    probe = twalk.generate_and_segment(tp, tcfg.tiny_config(), max_new_tokens=8, max_segs=8,
                                       eos_id=-1, device="cpu", visual_stream="clip",
                                       **inputs, **clip).tokens.numpy()
    vals, counts = np.unique(probe, return_counts=True)
    seg = int(vals[np.argmax(counts)])
    cfg_j, cfg_t = jcfg.tiny_config(seg_token_id=seg), tcfg.tiny_config(seg_token_id=seg)
    want = jax.jit(lambda p, x: jwalk.generate_and_segment(
        p, cfg_j, max_new_tokens=8, max_segs=8, eos_id=-1, visual_stream="clip", **x))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in {**inputs, **clip}.items()})
    got = twalk.generate_and_segment(tp, cfg_t, max_new_tokens=8, max_segs=8, eos_id=-1,
                                     device="cpu", visual_stream="clip", **inputs, **clip)
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any()
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks),
                               rtol=0, atol=1e-4)
    sam = twalk.generate_and_segment(tp, cfg_t, max_new_tokens=8, max_segs=8, eos_id=-1,
                                     device="cpu", **inputs)
    assert not torch.equal(sam.tokens, got.tokens)
    with pytest.raises(ValueError, match="images_clip"):
        twalk.generate_and_segment(tp, cfg_t, max_new_tokens=2, max_segs=2, eos_id=-1,
                                   device="cpu", visual_stream="clip", **inputs)


def test_eval_cli_clip_stream_runs(tmp_path):
    """evaluate.main --visual_stream clip at tiny_config on a synthetic
    manifest (frames read with cv2): one response per question, and
    count_params equal to JAX's at the same flags."""
    from walkgpt_tpu_torch.runtime import evaluate as tev
    from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest
    write_manifest(str(tmp_path / "data"), 3, seed=2, height=40, width=56, frames=True)
    out = tmp_path / "responses.json"
    res = tev.main(["--dataset_dir", str(tmp_path / "data"), "--model_size", "tiny",
                    "--precision", "fp32", "--max_new_tokens", "6", "--val_batch_size", "2",
                    "--visual_stream", "clip", "--no_console_text",
                    "--save_responses_path", str(out), "--device", "cpu"])
    data = json.loads(out.read_text())
    assert len(data) == 4 and all(d["response"].startswith("Question: ") for d in data)
    assert res["images_per_sec"] > 0
    args = tev.parse_args(["--model_size", "tiny", "--precision", "fp32", "--device", "cpu"])
    cfg = tev.build_config(args, 300)
    assert tnn.count_params(tev.build_model(args, cfg)) == jnn.count_params(
        jax.eval_shape(lambda: jwalk.init(jax.random.PRNGKey(0), jcfg.tiny_config())))
