"""The whole slice in the two production formats: `generate_and_segment` of
the PyTorch port against the JAX package on JAX's `init_quantized`
parameters, at tiny_config with the LLM widened to hidden 128 so that every
fused branch runs (the fused q/k/v width 384 takes K5's 128-column tiles).

- WalkGPT-7B's format: int4 MLPs, fused q/k/v and lm_head, W8A8 o-proj,
  W8A8 SAM blocks, the packed int4 flat cache (K4 pack4, K5, K6);
- WalkGPT-1B's format: W8A8 everywhere with the fused qkv8, W8A8 SAM
  blocks, the int8 flat cache (K4, K7).

Both run the attention kernels' path (plain versions here, Pallas interpret
mode on the JAX side). Tolerances: tokens, lengths, seg_rows and seg_valid
identical; mask logits and scores within atol 1e-4 in fp32 (the end of the
whole pipeline, as in tests/test_torch_walkgpt.py). W8A8 requantizes every
activation, and K4 and K6 round to bf16 inside, so where an fp32 ulp of
difference upstream (another summation order) meets a value on the edge
between two codes or two bf16 steps, the states move by 1e-4 to 1e-2 from
there on; the inputs here are ones on which nothing moves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import int4 as tint4

FORMATS = {
    "int4_flat": dict(act_quant=True, sam_int8=True, mlp_int4=True, attn_int4=True,
                      head_int4=True),
    "int8_flat": dict(act_quant=True, sam_int8=True),
}
FUSED = {"int4_flat": ("decode_attention_q_reference", "int4_matmul_pallas_reference",
                       "fused_mlp_int4_reference"),
         "int8_flat": ("decode_attention_q_reference", "fused_mlp_int8_reference")}


def _configs(kv, seg=300):
    jc = jcfg.tiny_config(seg_token_id=seg).replace(clip=None, kv_quant_cache=kv,
                                                     use_flash_attention=True)
    tc = tcfg.tiny_config(seg_token_id=seg).replace(kv_quant_cache=kv, use_flash_attention=True)
    return (jc.replace(llm=dataclasses.replace(jc.llm, hidden_size=128)),
            tc.replace(llm=dataclasses.replace(tc.llm, hidden_size=128)))


@pytest.fixture(scope="module", params=sorted(FORMATS))
def setup(request):
    kv = request.param
    jc, tc = _configs(kv)
    p = jax.device_get(jwalk.init_quantized(jax.random.PRNGKey(0), jc, dtype=jnp.float32,
                                            **FORMATS[kv]))
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 500, size=(3, 12))
    ids[0, 2] = ids[1, 4] = ids[2, 1] = -200                  # <image> sentinels
    mask = np.ones((3, 12), bool)
    mask[1, 9:] = False                                        # ragged prompt rows
    mask[2, 6:] = False
    inputs = dict(images=rng.randn(2, 64, 64, 3).astype(np.float32), input_ids=ids,
                  attention_mask=mask, row_image_idx=np.array([0, 1, 1]),
                  pixel_hw=np.array([[48, 64], [64, 40]]))
    pt = from_numpy_tree(p, "cpu")
    # [SEG] and EOS from a probe run: [SEG]s in more than one row, a row that
    # stops early
    probe = twalk.generate_and_segment(pt, tc, max_new_tokens=8, max_segs=8, eos_id=-1,
                                       device="cpu", **inputs).tokens.numpy()
    vals, counts = np.unique(probe[1:], return_counts=True)
    seg = int(vals[np.argmax(counts)])
    late = [t for t in probe[2, 1:] if t != seg and t not in probe[:2]]
    return kv, p, pt, inputs, seg, (int(late[0]) if late else -1)


def test_quantized_generate_and_segment_matches_jax(setup, monkeypatch):
    kv, p, pt, inputs, seg, eos = setup
    jc, tc = _configs(kv, seg)
    want = jwalk.generate_and_segment(
        jax.tree_util.tree_map(jnp.asarray, p), jc, max_new_tokens=8, max_segs=8,
        eos_id=eos, **{k: jnp.asarray(v) for k, v in inputs.items()})
    calls = dict.fromkeys(FUSED[kv], 0)
    for name in FUSED[kv]:
        mod = tfa if name.startswith("decode") else tint4
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    got = twalk.generate_and_segment(pt, tc, max_new_tokens=8, max_segs=8, eos_id=eos,
                                     device="cpu", **inputs)
    assert min(calls.values()) > 0, calls                    # every fused branch ran
    for name in ("tokens", "lengths", "seg_valid", "seg_rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.seg_valid.any() and not got.seg_valid.all()
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.mask_scores.numpy(), np.asarray(want.mask_scores),
                               atol=1e-4, rtol=0)
