"""The whole slice: `generate_and_segment` of the PyTorch port against the JAX
package at tiny_config, with the attention kernels' path (use_flash_attention:
plain versions here, Pallas interpret mode on the JAX side) and with the
einsum path.

Tolerances: tokens, lengths, seg_rows and seg_valid identical. Mask logits
and scores within atol 1e-4 in fp32: the masks sit at the end of the whole
pipeline (encoder, MSQP, 2 LLM layers x 8 decode steps, CTP, mask decoder,
bilinear upsampling), so the few-ulp differences of each stage (another
summation order) compound; the observed drift is ~1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import walkgpt as twalk


@pytest.fixture(scope="module")
def setup():
    p = jax.device_get(jwalk.init(jax.random.PRNGKey(0), jcfg.tiny_config().replace(clip=None)))
    rng = np.random.RandomState(0)
    enc = p["sam"]["image_encoder"]
    enc["pos_embed"] = (0.1 * rng.randn(*enc["pos_embed"].shape)).astype(np.float32)
    for blk in enc["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk[k] = (0.5 * rng.randn(*blk[k].shape)).astype(np.float32)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200                  # <image> sentinels
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False                                        # ragged prompt rows
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    pt = from_numpy_tree(p, "cpu")
    # [SEG] and EOS ids chosen from a probe run so that [SEG]s occur in more
    # than one row and one row stops early
    probe = twalk.generate_and_segment(pt, tcfg.tiny_config(), max_new_tokens=8, max_segs=8,
                                       eos_id=-1, device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe[1:], return_counts=True)
    seg = int(vals[np.argmax(counts)])
    late = [t for t in probe[2, 1:] if t != seg and t not in probe[:2]]
    eos = int(late[0]) if late else -1
    return p, pt, inputs, seg, eos


@pytest.mark.parametrize("flash", [True, False])
def test_generate_and_segment_matches_jax(setup, flash):
    p, pt, inputs, seg, eos = setup
    jc = jcfg.tiny_config(seg_token_id=seg).replace(use_flash_attention=flash, clip=None)
    tc = tcfg.tiny_config(seg_token_id=seg).replace(use_flash_attention=flash)
    want = jwalk.generate_and_segment(
        jax.tree_util.tree_map(jnp.asarray, p), jc, max_new_tokens=8, max_segs=8,
        eos_id=eos, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = twalk.generate_and_segment(pt, tc, max_new_tokens=8, max_segs=8, eos_id=eos,
                                     device="cpu", **inputs)
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any() and not got.seg_valid.all()
    assert got.lengths.min() < 8 or eos == -1
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.mask_scores.numpy(), np.asarray(want.mask_scores),
                               atol=1e-4, rtol=0)
    final_t = twalk.finalize_masks(got.pred_masks, (48, 64), (96, 128))
    final_j = jwalk.finalize_masks(want.pred_masks, (48, 64), (96, 128))
    assert final_t.shape == (8, 96, 128)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(final_j), atol=1e-4, rtol=0)


def test_fast_windowed_attention_selects_nothing_under_the_kernels(setup):
    """As in the JAX package, fast_windowed_attention only changes the einsum
    SAM attention; with use_flash_attention the kernels run either way.
    Without them it selects the einsum attention's fast branch, held against
    the JAX package's: tokens, lengths and seg rows identical, masks and
    scores within atol 1e-4 in fp32 (as test_generate_and_segment_matches_jax;
    the branch reorders the bias sum and the softmax's division)."""
    p, pt, inputs, seg, eos = setup
    tc = tcfg.tiny_config(seg_token_id=seg).replace(use_flash_attention=True)
    kw = dict(max_new_tokens=8, max_segs=8, eos_id=eos, device="cpu", **inputs)
    base = twalk.generate_and_segment(pt, tc, **kw)
    fast = twalk.generate_and_segment(pt, tc.replace(fast_windowed_attention=True), **kw)
    assert torch.equal(base.tokens, fast.tokens) and torch.equal(base.seg_rows, fast.seg_rows)
    assert torch.equal(base.pred_masks, fast.pred_masks)
    jc = jcfg.tiny_config(seg_token_id=seg).replace(use_flash_attention=False, clip=None,
                                                    fast_windowed_attention=True)
    want = jwalk.generate_and_segment(
        jax.tree_util.tree_map(jnp.asarray, p), jc, max_new_tokens=8, max_segs=8,
        eos_id=eos, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = twalk.generate_and_segment(
        pt, tc.replace(fast_windowed_attention=True, use_flash_attention=False), **kw)
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("pred_masks", "mask_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
