"""The quantized formats of the PyTorch port against the JAX package: the
converters and packers (int codes and packed bytes bit-exact, scales
exact), the quantized branches of nn.linear, the int4 dual dots and the
init layouts.

Tolerances: codes, bytes and scales must be identical (the same fp32
arithmetic element by element). Products of fp32 activations with the
(exact) quantized weights: atol = rtol = 1e-5 (another summation order).
The W8A8 product in bf16 is compared exactly: the int32 product is exact and
every rounding point (x * inv in bf16, the final cast) is the same."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.core import nn as jnn
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops import int4 as jint4
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core import nn as tnn
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.ops import quant as tquant

TOL = dict(atol=1e-5, rtol=1e-5)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _same(got, want):
    """Trees of tensors / arrays / markers, identical leaf by leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, (bool, np.bool_)) or (np.ndim(want) == 0
                                                and np.asarray(want).dtype == bool):
        assert got is True and bool(want)
    else:
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _weights(seed, k, n):
    # ties at .5 of the quantization step are exercised by integer-valued
    # columns; random columns cover the rest
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    w[:, 0] = np.arange(k) - k // 2
    return w


@pytest.mark.parametrize("k,n", [(64, 48), (128, 200)])
def test_quantize_weight_and_convert_proj_bit_exact(k, n):
    w = _weights(k + n, k, n)
    b = np.random.RandomState(1).randn(n).astype(np.float32)
    for act in (False, True):
        want = jax.device_get(jquant.convert_proj({"w": jnp.asarray(w), "b": jnp.asarray(b)}, act))
        got = tquant.convert_proj({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, act)
        _same(got, want)


@pytest.mark.parametrize("k,n,pad_to", [(64, 48, 0), (128, 200, 128), (32, 512, 128)])
def test_quantize_weight4_pack_and_unpack_bit_exact(k, n, pad_to):
    w = _weights(k * n, k, n)
    want = jax.device_get(jint4.quantize_weight4(jnp.asarray(w), pad_to=pad_to))
    got = tint4.quantize_weight4(torch.from_numpy(w), pad_to=pad_to)
    _same(got, want)
    lo_j, hi_j = jint4.unpack4(jnp.asarray(want["w_p4"]), jnp.float32)
    lo_t, hi_t = tint4.unpack4(got["w_p4"], torch.float32)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(tint4.dequantize4(got).numpy(),
                                  np.asarray(jint4.dequantize4(_j(want))))


@pytest.mark.parametrize("i_dim,h", [(128, 64), (11008 // 16, 32), (384, 48)])
def test_pack_down4_tile_local_bit_exact(i_dim, h):
    assert tint4.tile_for(i_dim) == jint4.tile_for(i_dim)
    w = _weights(i_dim + h, i_dim, h)
    want = jax.device_get(jint4.pack_down4(jnp.asarray(w)))
    got = tint4.pack_down4(torch.from_numpy(w))
    _same(got, want)
    np.testing.assert_array_equal(tint4.dequantize_down4(got).numpy(),
                                  np.asarray(jint4.dequantize_down4(_j(want))))


def test_tile_for_and_odd_widths():
    for i_dim in (11008, 13824, 5504, 1376, 128, 96, 6):
        assert tint4.tile_for(i_dim) == jint4.tile_for(i_dim)
    with pytest.raises(ValueError):
        tint4.tile_for(7)


def test_quantize_rows_and_cache_row_quantizers_bit_exact():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 4, 16).astype(np.float32) * np.array([1, 1e-3, 30, 0])[:, None]
    xq_j, sx_j = jint4.quantize_rows(jnp.asarray(x))
    xq_t, sx_t = tint4.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx_j))
    q_j, s_j = jllm._quant_rows(jnp.asarray(x), jnp.int8)
    q_t, s_t = tllm._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_j[..., 0], np.float32))
    p_j, s_j = jllm._quant_pack4_flat(jnp.asarray(x))
    p_t, s_t = tllm._quant_pack4_flat(torch.from_numpy(x))
    assert p_t.dtype == torch.int8 and p_t.shape == (3, 5, 32)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_j, np.float32))


@pytest.fixture(scope="module")
def layer():
    cfg = dataclasses.replace(jcfg.LLAMA_TINY, hidden_size=128)
    return jax.device_get(jllm.init_layer(jax.random.PRNGKey(4), cfg))


@pytest.mark.parametrize("conv", ["qkv8", "int4", "mlp_int4"])
def test_attention_and_mlp_converters_bit_exact(layer, conv):
    if conv == "qkv8":
        want = jquant.convert_attn_qkv8(_j(layer["attn"]), True)
        got = tquant.convert_attn_qkv8(from_numpy_tree(layer["attn"], "cpu"), True)
    elif conv == "int4":
        want = jquant.convert_attn_int4(_j(layer["attn"]), True)
        got = tquant.convert_attn_int4(from_numpy_tree(layer["attn"], "cpu"), True)
    else:
        want = jquant.convert_mlp_int4(_j(layer["mlp"]))
        got = tquant.convert_mlp_int4(from_numpy_tree(layer["mlp"], "cpu"))
    _same(got, jax.device_get(want))


def test_converters_fall_back_for_biased_projections(layer):
    attn = {k: dict(v, b=np.ones(v["w"].shape[1], np.float32)) for k, v in layer["attn"].items()}
    up = layer["mlp"]["up"]
    mlp = dict(layer["mlp"], up=dict(up, b=np.ones(up["w"].shape[1], np.float32)))
    for jfn, tfn, tree in ((jquant.convert_attn_int4, tquant.convert_attn_int4, attn),
                           (jquant.convert_attn_qkv8, tquant.convert_attn_qkv8, attn)):
        _same(tfn(from_numpy_tree(tree, "cpu"), True), jax.device_get(jfn(_j(tree), True)))
    _same(tquant.convert_mlp_int4(from_numpy_tree(mlp, "cpu")),
          jax.device_get(jquant.convert_mlp_int4(_j(mlp))))


@pytest.mark.parametrize("fmt", ["a8", "w_q", "w_p4"])
def test_linear_quantized_branches_match_jax(fmt):
    rng = np.random.RandomState(6)
    w = rng.randn(64, 40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    x = rng.randn(2, 7, 64).astype(np.float32)
    x[0, 0] = 0.0                                    # an all-zero row: the 1e-8 floor
    if fmt == "w_p4":
        p = dict(jax.device_get(jint4.quantize_weight4(jnp.asarray(w))), b=b)
    else:
        p = jax.device_get(jquant.convert_proj({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                               fmt == "a8"))
    pt = from_numpy_tree(p, "cpu")
    want = jnn.linear(_j(p), jnp.asarray(x))
    got = tnn.linear(pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if fmt == "a8":
        # bf16: x * inv rounds to bf16 before the round to int; all codes and
        # roundings agree, so the outputs are identical
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        want = jnn.linear(_j(p), xb)
        got = tnn.linear(pt, torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_matmul_is_exact_at_a_deep_contraction():
    rng = np.random.RandomState(7)
    a = rng.randint(-127, 128, size=(5, 4096)).astype(np.int8)
    b = rng.randint(-127, 128, size=(4096, 24)).astype(np.int8)
    got = tnn.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_int4_dual_dots_and_xla_mlp_match_jax(layer):
    rng = np.random.RandomState(8)
    x = rng.randn(2, 5, 128).astype(np.float32)
    mlp = jax.device_get(jquant.convert_mlp_int4(_j(layer["mlp"])))
    mt = from_numpy_tree(mlp, "cpu")
    g = mlp["gate"]
    np.testing.assert_allclose(
        tint4.int4_matmul(torch.from_numpy(x), mt["gate"]["w_p4"], mt["gate"]["w_scale"]).numpy(),
        np.asarray(jint4.int4_matmul(jnp.asarray(x), jnp.asarray(g["w_p4"]),
                                     jnp.asarray(g["w_scale"]))), **TOL)
    h = rng.randn(10, 128).astype(np.float32)
    np.testing.assert_allclose(
        tint4._down_matmul_xla(mt["down"], torch.from_numpy(h)).numpy(),
        np.asarray(jint4._down_matmul_xla(_j(mlp["down"]), jnp.asarray(h))), **TOL)
    for act in ("silu", "gelu"):
        m = mlp if act == "silu" else {"fc1": mlp["gate"], "fc2": mlp["down"]}
        np.testing.assert_allclose(
            tint4.mlp_int4_xla(from_numpy_tree(m, "cpu"), torch.from_numpy(x), act).numpy(),
            np.asarray(jint4.mlp_int4_xla(_j(m), jnp.asarray(x), act)), **TOL)
    assert tint4.mlp_is_int4(mt) and not tint4.mlp_is_w8a8(mt)


def test_quantize_llm_and_sam_encoder_bit_exact():
    cfg = jcfg.tiny_config().replace(clip=None)
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, hidden_size=128))
    p = jax.device_get(jwalk.init(jax.random.PRNGKey(9), cfg))
    pt = from_numpy_tree(p, "cpu")
    for kw in (dict(act_quant=True), dict(act_quant=True, mlp_int4=True, attn_int4=True,
                                          head_int4=True)):
        _same(tquant.quantize_llm(pt["llm"], **kw),
              jax.device_get(jquant.quantize_llm(_j(p["llm"]), **kw)))
    _same(tquant.quantize_sam_encoder(pt["sam"], act_quant=True),
          jax.device_get(jquant.quantize_sam_encoder(_j(p["sam"]), act_quant=True)))


@pytest.mark.parametrize("fmt", [
    dict(act_quant=True, sam_int8=True),
    dict(act_quant=True, sam_int8=True, mlp_int4=True, attn_int4=True, head_int4=True)])
def test_init_quantized_layout_matches_jax(fmt):
    """Key paths, shapes and dtypes of the port's own init_quantized are the
    JAX package's (values differ: other generators)."""
    jc = jcfg.tiny_config().replace(clip=None)
    tc = tcfg.tiny_config()
    want = jax.device_get(jax.eval_shape(
        lambda k: jwalk.init_quantized(k, jc, dtype=jnp.bfloat16, **fmt),
        jax.random.PRNGKey(0)))
    got = twalk.init_quantized(tc, seed=0, dtype=torch.bfloat16, device="cpu", **fmt)

    def sig(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in sig(v, f"{prefix}{k}/").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in sig(v, f"{prefix}{i}/").items()}
        if tree is None:
            return {prefix: None}
        if isinstance(tree, bool) or (hasattr(tree, "dtype") and tree.shape == ()
                                      and str(tree.dtype) == "bool"):
            return {prefix: "marker"}
        return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}
    assert sig(got) == sig(want)


def test_quantized_llm_init_is_quantize_llm_of_init():
    cfg = tcfg.LLAMA_TINY
    kw = dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    _same(tquant.quantized_llm_init(g1, cfg, torch.float32, **kw),
          tquant.quantize_llm(tllm.init(g2, cfg, torch.float32), **kw))
