"""The JAX package's decode switches in the PyTorch port: each one read from
the environment at import with the JAX package's name and default, and each
one, set alike in both packages, giving JAX's tokens.

- WALKGPT_QDOT8 -> ops/flash_attention.DECODE_QDOT8 (K4's int8 scores);
- WALKGPT_PVDOT8 -> DECODE_PVDOT8 (K4's int8 value product);
- WALKGPT_DECODE_BLOCK -> DECODE_BLOCK (the walk's block, the cache rounding);
- WALKGPT_FUSED_MLP8 -> models/llm._FUSED_MLP8 (K7 for W8A8 MLPs);
- WALKGPT_FUSED_LAYER -> ops/fused_layer.FUSED_LAYER (K12 in every step).

The JAX package binds its kernels' `block` default at import, so a test
that sets DECODE_BLOCK there also sets decode_attention_q's default, which
is what WALKGPT_DECODE_BLOCK at import gives it.

Tolerances: greedy tokens identical; predictor hidden states within 2e-4
(K4 and K6 round to bf16 inside, as tests/test_torch_decode_caches.py
says). The SAM encoder's fast einsum branch (the eval CLI's --fast where
flash attention is off) in bf16 against JAX's: within 4 bf16 steps of
outputs of order one (bias, logits and probabilities round to bf16 at the
same points; the products' sums run in another order)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import sam_encoder as jenc
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.ops import fused_layer as jfl
from walkgpt_tpu.ops.quant import quantize_llm as jquantize_llm
from walkgpt_tpu.runtime import generate as jgen
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import sam_encoder as tenc
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import fused_layer as tfl
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.runtime import generate as tgen

ENV = {"WALKGPT_QDOT8": "0", "WALKGPT_PVDOT8": "1", "WALKGPT_DECODE_BLOCK": "128",
       "WALKGPT_FUSED_MLP8": "0", "WALKGPT_FUSED_LAYER": "1"}
WIDE = dataclasses.replace(LLAMA_TINY, hidden_size=128)      # K5's tiles, K12's MHA


def test_switches_read_from_the_environment():
    """Unset, each constant holds the JAX package's default; set, a fresh
    import reads each variable."""
    assert (tfa.DECODE_QDOT8, tfa.DECODE_PVDOT8, tfa.DECODE_BLOCK, tllm._FUSED_MLP8,
            tfl.FUSED_LAYER) == (jfa.DECODE_QDOT8, jfa.DECODE_PVDOT8, jfa.DECODE_BLOCK,
                                 jllm._FUSED_MLP8, jfl.FUSED_LAYER)
    code = ("from walkgpt_tpu_torch.ops import flash_attention as fa, fused_layer as fl\n"
            "from walkgpt_tpu_torch.models import llm\n"
            "print(fa.DECODE_QDOT8, fa.DECODE_PVDOT8, fa.DECODE_BLOCK, llm._FUSED_MLP8, "
            "fl.FUSED_LAYER)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, **ENV)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["False", "True", "128", "False", "True"]


def _llm(kind):
    """(JAX config, JAX tree, kv cache) of a switch's format: dense LLAMA_TINY
    over int8_flat (K4), the 1B format W8A8 over int8_flat (K7), or the 7B
    format int4x at hidden 128 over int4_flat (K12)."""
    cfg = WIDE if kind == "int4x" else LLAMA_TINY
    p = jllm.init(jax.random.PRNGKey(11), cfg)
    if kind == "w8a8":
        p = jquantize_llm(p, act_quant=True)
    elif kind == "int4x":
        p = jquantize_llm(p, act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)
    return cfg, jax.device_get(p), "int4_flat" if kind == "int4x" else "int8_flat"


SWITCHES = {
    # name: (format, [(module, attribute, value)] of the JAX side, of the port)
    "qdot8_off": ("dense", [(jfa, "DECODE_QDOT8", False)], [(tfa, "DECODE_QDOT8", False)]),
    "pvdot8_on": ("dense", [(jfa, "DECODE_PVDOT8", True)], [(tfa, "DECODE_PVDOT8", True)]),
    "decode_block_16": ("dense", [(jfa, "DECODE_BLOCK", 16)], [(tfa, "DECODE_BLOCK", 16)]),
    "fused_mlp8_off": ("w8a8", [(jllm, "_FUSED_MLP8", False)], [(tllm, "_FUSED_MLP8", False)]),
    "fused_layer_on": ("int4x", [(jfl, "FUSED_LAYER", True)], [(tfl, "FUSED_LAYER", True)]),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_matches_jax(switch, monkeypatch):
    kind, jset, tset = SWITCHES[switch]
    cfg, p, kv = _llm(kind)
    rng = np.random.RandomState(12)
    emb = rng.randn(2, 10, cfg.hidden_size).astype(np.float32)
    mask = np.arange(10)[None] < np.array([[10], [7]])
    n_new = 4 if kind == "int4x" else 8
    for mod, name, value in jset:
        monkeypatch.setattr(mod, name, value)
    if switch == "decode_block_16":
        monkeypatch.setitem(jfa.decode_attention_q.__kwdefaults__, "block", 16)
    jax.clear_caches()                 # nothing traced under the other setting is reused
    want = jgen.greedy_generate(jax.tree_util.tree_map(jnp.asarray, p), cfg, jnp.asarray(emb),
                                jnp.asarray(mask), max_new_tokens=n_new, eos_id=-1,
                                kv_quant=kv)
    jax.clear_caches()
    for mod, name, value in tset:
        monkeypatch.setattr(mod, name, value)
    seen = []
    spies = {"dense": (tfa, "_walk_blocks"), "w8a8": (tint4, "fused_mlp_int8"),
             "int4x": (tllm, "fused_layer_tail")}
    mod, name = spies[kind]

    def spy(*a, _fn=getattr(mod, name), **k):
        seen.append((a, k))
        return _fn(*a, **k)
    monkeypatch.setattr(mod, name, spy)
    tc = tcfg.LLMConfig(**dataclasses.asdict(cfg))
    got = tgen.greedy_generate(from_numpy_tree(p, "cpu"), tc, torch.from_numpy(emb),
                               torch.from_numpy(mask),
                               max_new_tokens=n_new, eos_id=-1, kv_quant=kv)
    steps = n_new * cfg.num_layers
    if switch == "fused_mlp8_off":
        assert not seen                                          # no K7
    else:
        assert len(seen) == steps, (switch, len(seen))
    if switch == "qdot8_off":          # the bf16 q's scores: one scale, no per-head codes
        assert all(not torch.is_tensor(a[1]) for a, _ in seen)
    elif switch == "pvdot8_on":
        assert all(k["pv_int8"] for _, k in seen)
    elif switch == "decode_block_16":
        assert all(k["bl"] == 16 for _, k in seen)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.pred_hidden.numpy(), np.asarray(want.pred_hidden),
                               atol=2e-4, rtol=0)


def test_fast_sam_attention_bf16_matches_jax():
    """sam_encoder._attention's fast branch on ViT-tiny windows (16 heads of
    a 14-wide window would be ViT-H's; here 2 heads of 8) in bf16."""
    rng = np.random.RandomState(13)
    c, heads, ws = 32, 2, 8
    blk = {"qkv": {"w": 0.2 * rng.randn(c, 3 * c), "b": 0.1 * rng.randn(3 * c)},
           "proj": {"w": 0.2 * rng.randn(c, c), "b": 0.1 * rng.randn(c)},
           "rel_pos_h": 0.5 * rng.randn(2 * ws - 1, c // heads),
           "rel_pos_w": 0.5 * rng.randn(2 * ws - 1, c // heads)}
    blk = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), blk)
    x = rng.randn(3, ws, ws, c).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), blk)
    want = jenc._attention(jp, jnp.asarray(x, jnp.bfloat16), heads, True, use_flash=False,
                           fast=True, windowed=True)
    tp = from_numpy_tree(blk, "cpu", torch.bfloat16)
    got = tenc._attention(tp, torch.from_numpy(x).bfloat16(), heads, True, False,
                          windowed=True, fast=True)
    plain = tenc._attention(tp, torch.from_numpy(x).bfloat16(), heads, True, False,
                            windowed=True)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(w).max())
    np.testing.assert_allclose(got.float().numpy(), w, atol=4 * 2 ** -8 * scale, rtol=0)
    assert not torch.equal(got, plain)             # the branch differs from the plain one
