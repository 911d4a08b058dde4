"""The GSPMD leg's layout (walkgpt_tpu_torch/parallel/sharding.py,
parallel/infer.mesh_config and shard_params) against the JAX package's
parallel/sharding.py and parallel/infer.py, with no launch:

  * param_pspecs spec for spec against JAX's on tiny_config trees (dense
    with the CLIP tower, quantize_llm int8 and W8A8, the int4x format, the
    int8 SAM blocks) at tp 2, 3 and 4 (3 divides few of tiny_config's
    widths, so _spec_for's drop replicates most split leaves there);
  * kv_cache_pspecs on the heads, flat and scale leaves at (tp 4, dp 2) and
    (tp 3, dp 3), as tests/test_infer_sharded.py:102-116;
  * mesh_config against JAX's result on the CPU backend;
  * shard_params: the tp ranks' blocks concatenated along each split
    dimension give the whole leaf back, bit for bit (and cache_constrainer's
    blocks the whole cache)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.ops.quant import quantize_llm, quantize_sam_encoder
from walkgpt_tpu.parallel import infer as jinfer
from walkgpt_tpu.parallel import sharding as jshd
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.parallel import gspmd, infer, sharding

INT4X = dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)


def _trees():
    """{name: JAX numpy tree} of tiny_config in each format."""
    cfg = jcfg.tiny_config()
    dense = jax.device_get(jwalk.init(jax.random.PRNGKey(0), cfg))
    int4x = jax.device_get(jwalk.init_quantized(jax.random.PRNGKey(1), cfg, jnp.float32,
                                                **INT4X))
    return {
        "dense_clip": dense,
        "int8": dict(dense, llm=jax.device_get(quantize_llm(dense["llm"]))),
        "w8a8": dict(dense, llm=jax.device_get(quantize_llm(dense["llm"], act_quant=True))),
        "int4x": int4x,
        "sam_int8": dict(dense, sam=jax.device_get(quantize_sam_encoder(dense["sam"]))),
    }


@pytest.fixture(scope="module")
def trees():
    return _trees()


def _jax_specs(tree, tp):
    """JAX's param_pspecs as {path: spec padded to the leaf's rank}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jshd.param_pspecs(tree, tp=tp),
                                                   is_leaf=lambda s: isinstance(s, P))
    leaves = {jshd._path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for path, spec in flat:
        key = jshd._path_str(path)
        nd = np.ndim(leaves[key])
        out[key] = tuple(spec) + (None,) * (nd - len(tuple(spec)))
    return out


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("name", ["dense_clip", "int8", "w8a8", "int4x", "sam_int8"])
def test_param_pspecs_equal_jax(trees, name, tp):
    """Every leaf's spec equals JAX's, the markers' () included; at tp 3
    the embedding (512 rows) is replicated by _spec_for's drop, at tp 2 and
    4 it splits."""
    jtree = trees[name]
    want = _jax_specs(jtree, tp)
    got = sharding.param_pspecs(from_numpy_tree(jtree, "cpu"), tp=tp)
    assert got == want
    assert got["llm/embed_tokens/w"] == ((None, None) if tp == 3 else ("tp", None))


def test_rank_holds_the_split_embedding_and_towers(trees):
    """The leaves the GSPMD leg splits over tp at tp 2: the embedding's
    vocabulary rows, a dense head's hidden rows, the SAM encoder's qkv /
    fc1 columns and proj / fc2 rows, the CLIP tower's; the packed int4
    formats whole, their column-parallel scales split."""
    dense = sharding.param_pspecs(from_numpy_tree(trees["dense_clip"], "cpu"), tp=2)
    int4x = sharding.param_pspecs(from_numpy_tree(trees["int4x"], "cpu"), tp=2)
    sam = "sam/image_encoder/blocks/0/"
    clip = "clip/layers/0/"
    assert dense["llm/embed_tokens/w"] == ("tp", None)
    assert dense["llm/lm_head/w"] == ("tp", None)
    assert dense[sam + "qkv/w"] == (None, "tp") and dense[sam + "proj/w"] == ("tp", None)
    assert dense[sam + "mlp/fc1/w"] == (None, "tp") and dense[sam + "mlp/fc2/w"] == ("tp", None)
    assert dense[clip + "attn/q/w"] == (None, "tp") and dense[clip + "attn/out/w"] == ("tp", None)
    assert dense[clip + "mlp/fc1/b"] == ("tp",) and dense[clip + "mlp/fc2/b"] == (None,)
    assert int4x["llm/layers/0/attn/qkv4/w_p4"] == (None, None)
    assert int4x["llm/layers/0/mlp/gate/w_p4"] == (None, None)
    assert int4x["llm/layers/0/mlp/gate/w_scale"] == ("tp",)
    assert int4x["llm/layers/0/attn/o/w_q"] == ("tp", None)
    assert int4x["llm/lm_head/w_p4"] == (None, None)


@pytest.mark.parametrize("tp,dp", [(4, 2), (3, 3)])
def test_kv_cache_pspecs_equal_jax(tp, dp):
    """Heads, flat and scale leaves, int8 and fp, against JAX's specs of
    JAX's caches of the same config (axes that do not divide stay whole)."""
    for quant, layout in (("int8", "heads"), ("int8", "flat"), ("", "heads"), ("int4", "flat")):
        jcache = jllm.init_kv_cache(jcfg.LLAMA_TINY, 4, 32, quant=quant or False,
                                    layout=layout)
        tcache = tllm.init_kv_cache(tcfg.LLAMA_TINY, 4, 32, quant=quant, layout=layout,
                                    device="cpu")
        want = {k: tuple(s) + (None,) * (np.ndim(jcache[k]) - len(tuple(s)))
                for k, s in jshd.kv_cache_pspecs(jcache, tp=tp, dp=dp).items()}
        got = sharding.kv_cache_pspecs(tcache, tp=tp, dp=dp)
        assert {k: got[k] for k in want} == want, (quant, layout)
    if (tp, dp) == (4, 2):
        heads = tllm.init_kv_cache(tcfg.LLAMA_TINY, 4, 32, quant="int8", device="cpu")
        specs = sharding.kv_cache_pspecs(heads, tp=tp, dp=dp)
        assert specs["k"] == (None, "dp", "tp", None, None)
        assert specs["k_scale"] == (None, "dp", "tp", None)


def test_mesh_config_is_jaxs_cpu_result():
    """The port keeps every switch, as JAX does on its CPU backend."""
    for kv, flash in (("int4_flat", True), ("int8_flat", False), ("int8", True), (False, True)):
        jc = jcfg.tiny_config().replace(kv_quant_cache=kv, use_flash_attention=flash)
        tc = tcfg.tiny_config().replace(kv_quant_cache=kv, use_flash_attention=flash)
        for tp in (1, 2, 8):
            want, got = jinfer.mesh_config(jc, tp=tp), infer.mesh_config(tc, tp=tp)
            assert (got.kv_quant_cache, got.use_flash_attention) == (
                want.kv_quant_cache, want.use_flash_attention)
            assert got == tc


def _mesh(tp, i, dp=1, d=0):
    return types.SimpleNamespace(tp=tp, tp_index=i, dp=dp, dp_index=d)


@pytest.mark.parametrize("name", ["dense_clip", "int8", "w8a8", "int4x", "sam_int8"])
def test_shard_params_concatenate_to_the_whole_tree(trees, name):
    """tp 2: each rank's block has 1/tp of a split leaf, the whole of every
    other; the blocks concatenated along the split dimension equal the
    whole leaf bit for bit; a split block carries its split dimension
    (gspmd.split_axis, what the rank programs read), a whole leaf none; a
    rank's bytes are what the specs give."""
    whole = from_numpy_tree(trees[name], "cpu")
    specs = sharding.param_pspecs(whole, tp=2)
    ranks = [infer.shard_params(whole, _mesh(2, i)) for i in range(2)]
    flat = [leaves_with_path(r) for r in ranks]
    expect_bytes = 0
    for path, x in leaves_with_path(whole).items():
        if not torch.is_tensor(x):
            assert all(f[path] == x for f in flat)
            continue
        dim = next((i for i, n in enumerate(specs[path]) if n == "tp"), None)
        assert all(gspmd.split_axis(f[path]) == dim for f in flat), path
        if dim is None:
            assert all(torch.equal(f[path], x) for f in flat)
            expect_bytes += x.numel() * x.element_size()
            continue
        parts = [f[path] for f in flat]
        assert all(p.shape[dim] * 2 == x.shape[dim] for p in parts)
        assert torch.equal(torch.cat(parts, dim), x)
        expect_bytes += x.numel() * x.element_size() // 2
    assert all(infer.param_bytes(r) == expect_bytes for r in ranks)
    assert expect_bytes < infer.param_bytes(whole)


def test_cache_constrainer_blocks_tile_the_cache():
    """The dp x tp ranks' blocks of a flat int8 cache tile it: batch rows
    over dp, the lanes over tp."""
    cache = tllm.init_kv_cache(tcfg.LLAMA_TINY, 4, 16, quant="int8", layout="flat",
                               device="cpu")
    cache = {k: torch.randint(-100, 100, v.shape).to(v.dtype) for k, v in cache.items()}
    blocks = {(d, t): sharding.cache_constrainer(_mesh(2, t, 2, d))(cache)
              for d in range(2) for t in range(2)}
    assert blocks[0, 1]["k"].shape == (2, 2, 16, 64 // 2)
    assert blocks[0, 1]["k_scale"].shape == (2, 2, 2, 16)
    for name in ("k", "k_scale"):
        lane = 3 if name == "k" else 2
        rows = [torch.cat([blocks[d, t][name] for t in range(2)], lane) for d in range(2)]
        assert torch.equal(torch.cat(rows, 1), cache[name])
