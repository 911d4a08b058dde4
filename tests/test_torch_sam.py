"""SAM encoder, prompt encoder and mask decoder of the PyTorch port against
the JAX package, on the same parameters and inputs (tiny config, fp32).

Tolerance atol = rtol = 1e-5 in fp32: the two packages run the same
arithmetic in another summation order (XLA:CPU vs ATen kernels; the
Pallas kernels in interpret mode on the JAX flash path), a few ulp on
activations of order one after LayerNorm."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import sam as jsam
from walkgpt_tpu.ops import resize as jresize
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import sam as tsam
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import resize as tresize

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny_config()
    scfg = jsam.SamConfig(encoder=cfg.sam, prompt=cfg.prompt_encoder,
                          decoder=cfg.mask_decoder)
    rng = np.random.RandomState(1)
    p = _with_tables(jax.device_get(jsam.init(jax.random.PRNGKey(1), scfg)), rng)
    return scfg, p, twalk.sam_config(tcfg.tiny_config()), from_numpy_tree(p, "cpu"), rng


def _with_tables(p, rng):
    """Zero-initialised tables get values, so the rel-pos and pos-embed
    paths carry signal."""
    enc = p["image_encoder"]
    enc["pos_embed"] = (0.1 * rng.randn(*enc["pos_embed"].shape)).astype(np.float32)
    for blk in enc["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk[k] = (0.5 * rng.randn(*blk[k].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("window", [2, 3])
def test_encoder_matches_jax(setup, use_flash, window):
    """window 3 does not divide the 4x4 grid: window_partition pads it to
    6x6 with zeros (4 windows of 9 tokens, as ViT-H pads 64 to 70) and the
    padded windows go through the windowed attention too."""
    scfg, p, tscfg, pt, rng = setup
    if window != scfg.encoder.window_size:
        scfg = dataclasses.replace(scfg, encoder=dataclasses.replace(scfg.encoder,
                                                                    window_size=window))
        tscfg = dataclasses.replace(tscfg, encoder=dataclasses.replace(tscfg.encoder,
                                                                      window_size=window))
        p = _with_tables(jax.device_get(jsam.init(jax.random.PRNGKey(7), scfg)), rng)
        pt = from_numpy_tree(p, "cpu")
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    want = jsam.encode_image(jax.tree_util.tree_map(jnp.asarray, p), scfg,
                             jnp.asarray(images), use_flash=use_flash)
    got = tsam.encode_image(pt, tscfg, torch.from_numpy(images), use_flash=use_flash)
    assert got.shape == want.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prompt_encoder_and_mask_decoder_match_jax(setup):
    scfg, p, tscfg, pt, rng = setup
    feats = rng.randn(3, 4, 4, 32).astype(np.float32)
    text = rng.randn(3, 1, 32).astype(np.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    np.testing.assert_allclose(
        tsam.sam_prompt.get_dense_pe(pt["prompt_encoder"], tscfg.prompt).numpy(),
        np.asarray(jsam.sam_prompt.get_dense_pe(pj["prompt_encoder"], scfg.prompt)), **TOL)
    for multimask in (False, True):
        want_m, want_iou = jsam.decode_masks(pj, scfg, jnp.asarray(feats),
                                             text_embeds=jnp.asarray(text),
                                             multimask_output=multimask)
        got_m, got_iou = tsam.decode_masks(pt, tscfg, torch.from_numpy(feats),
                                           text_embeds=torch.from_numpy(text),
                                           multimask_output=multimask)
        assert got_m.shape == want_m.shape
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
        np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou), **TOL)


def test_preprocess_matches_jax():
    rng = np.random.RandomState(3)
    img = (255 * rng.rand(2, 40, 56, 3)).astype(np.float32)
    np.testing.assert_allclose(tsam.preprocess(torch.from_numpy(img), 64).numpy(),
                               np.asarray(jsam.preprocess(jnp.asarray(img), 64)), **TOL)


@pytest.mark.parametrize("size", [(16, 16), (64, 48), (5, 3)])
def test_bilinear_resize_matches_jax(size):
    x = np.random.RandomState(4).randn(3, 6, 6, 2).astype(np.float32)
    np.testing.assert_allclose(tresize.bilinear_resize(torch.from_numpy(x), size).numpy(),
                               np.asarray(jresize.bilinear_resize(jnp.asarray(x), size)),
                               **TOL)
