"""K6's, K8's and K4's launch plans (ops/int4.fused_mlp_int4_plan,
ops/flash_attention.decode_chunk_plan and chunk_key_blocks,
decode_attention_q_plan), which mirror the grids of csrc/mlp4_stream.cuh,
csrc/decode_chunk.cuh and csrc/decode_walk.cuh, and K6's plain version
against the JAX package at the 7B server's pool of 4 rows.

The plans are checked for coverage at the shapes of the repository's
configurations: every column and tile of K6's two passes and every output
element of K8 and of K4 (on either of its engines) is owned by exactly one
block, and K8's and K4's key blocks hold every key their rows attend. K6's plain version is held as
tests/test_torch_quant_kernels.py holds it (atol = rtol = 1e-4: h is rounded
to bf16 before the down product, so an fp32 last place in silu(g) * u can
move one element of h by a bf16 step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core.config import LLAMA_TINY
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.ops import int4 as jint4
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import int4 as tint4

CONFIGS = {
    "7B": tcfg.walkgpt_7b_config().llm,
    "13B": tcfg.walkgpt_13b_config().llm,
    "1B": tcfg.flagship_1b_config().llm,
    "demo": tcfg.demo_config().llm,
}


@pytest.mark.parametrize("name", list(CONFIGS) + ["ragged"])
@pytest.mark.parametrize("m", [1, 2, 4, 17])
def test_k6_plan_covers_every_column_tile_and_row_once(name, m):
    h, i_dim = (160, 96) if name == "ragged" else (CONFIGS[name].hidden_size,
                                                    CONFIGS[name].intermediate_size)
    plan = tint4.fused_mlp_int4_plan(m, h, i_dim)
    tile, n_tiles = plan["tile"], plan["n_tiles"]
    assert tile == tint4.tile_for(i_dim) and n_tiles * tile == i_dim
    # gate/up: block k owns columns [32 k, 32 k + 32) of I, all packed rows
    cols = np.zeros(i_dim, int)
    for k in range(plan["gate_up_blocks"]):
        cols[k * tint4.MLP4_GATE_UP_COLS:(k + 1) * tint4.MLP4_GATE_UP_COLS] += 1
    assert (cols == 1).all()
    # down: block (s, t) owns tile t's rows and output columns [512 s, 512 s + 512)
    n_slices = plan["down_blocks"] // n_tiles
    assert n_slices * n_tiles == plan["down_blocks"]
    owned = np.zeros((n_tiles, h), int)
    for t in range(n_tiles):
        for s in range(n_slices):
            owned[t, s * tint4.MLP4_DOWN_COLS:(s + 1) * tint4.MLP4_DOWN_COLS] += 1
    assert (owned == 1).all()
    # rows in passes, each row once
    rows = np.zeros(m, int)
    for m0 in range(0, m, plan["rows_per_pass"]):
        rows[m0:m0 + plan["rows_per_pass"]] += 1
    assert plan["rows_per_pass"] in (1, 2, 4) and (rows == 1).all()
    # the tiles' partials, then h in bf16, 16-byte aligned
    assert plan["h_offset"] == n_tiles * m * h and plan["h_offset"] % 4 == 0
    assert (plan["scratch_floats"] - plan["h_offset"]) * 2 >= m * i_dim


def _k8_shapes():
    shapes = {n: (c.num_heads, c.num_kv_heads, c.head_dim) for n, c in CONFIGS.items()}
    shapes.update({"ragged GQA odd n_kv": (6, 3, 40), "n_rep 8": (16, 2, 24)})
    return shapes


@pytest.mark.parametrize("name", list(_k8_shapes()))
@pytest.mark.parametrize("tc", [1, 9, 16])
def test_k8_plan_owns_every_output_once(name, tc):
    h, n_kv, d = _k8_shapes()[name]
    b, bl = 2, 256
    plan = tfa.decode_chunk_plan(b, tc, h, n_kv, d, bl)
    gx, gy, gz = plan["grid"]
    qg, n_rep = plan["query_rows"], h // n_kv
    owned = np.zeros((b, tc, h, d), int)
    for x in range(gx):
        bb, kv = divmod(x, n_kv)
        for y in range(gy):
            for g in range(y * qg, min((y + 1) * qg, tc * n_rep)):
                t, r = divmod(g, n_rep)
                for z in range(gz):
                    d0 = z * tfa.CHUNK_VALUE_DIMS
                    owned[bb, t, kv * n_rep + r, d0:d0 + tfa.CHUNK_VALUE_DIMS] += 1
    assert (owned == 1).all()
    assert qg <= tfa.CHUNK_QUERY_ROWS
    # two blocks an SM at the production shapes (D = 128, DECODE_BLOCK keys)
    for qdot8 in (True, False):
        smem = tfa.decode_chunk_plan(b, tc, h, n_kv, d, bl, qdot8)["smem"]
        assert smem <= tfa._SMEM_MAX // 2 or d != 128, smem


@pytest.mark.parametrize("cl,tc,l,bl", [(440, 9, 512, 256), (375, 9, 512, 256), (0, 9, 512, 256),
                                         (503, 9, 512, 256), (255, 1, 512, 256), (30, 4, 48, 16),
                                         (63, 1, 64, 32)])
def test_k8_key_blocks_hold_every_attended_key(cl, tc, l, bl):
    """Token t attends slots < cl + t + 1 (capped by the cache): the walked
    blocks hold all of them, and a block past them would hold none."""
    nvb = tfa.chunk_key_blocks(cl, tc, l, bl)
    attended = min(cl + tc, l)
    assert nvb * bl >= attended and nvb <= l // bl
    assert (nvb - 1) * bl < attended


@pytest.mark.parametrize("name", list(_k8_shapes()))
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("qdot8,pv8,walk", [(True, False, False), (False, False, False),
                                            (True, True, False), (True, False, True)])
def test_k4_plan_owns_every_output_once(name, b, qdot8, pv8, walk):
    """K4 runs the chunk engine at Tc = 1 (one query row a block where n_rep
    is 1; value slices of STEP_VALUE_DIMS, or CHUNK_VALUE_DIMS where n_rep is
    over 8), or the walk (a block per (row, kv head) and query group, every
    dim) for the int8 value product and for decode_attention_q_walk; no
    thread of the chunk engine holds more than two value chains."""
    h, n_kv, d = _k8_shapes()[name]
    bl = 256
    plan = tfa.decode_attention_q_plan(b, h, n_kv, d, bl, qdot8, pv8, walk)
    chunk = not (walk or pv8)
    assert plan["engine"] == ("chunk" if chunk else "walk")
    gx, gy, gz = plan["grid"]
    qg, n_rep = plan["query_rows"], h // n_kv
    dims = plan["value_dims"]
    if chunk:
        assert dims == (tfa.STEP_VALUE_DIMS if n_rep <= 8 else tfa.CHUNK_VALUE_DIMS)
        assert qg * dims <= 2 * tfa.CHUNK_THREADS
    else:
        assert dims == d
    assert gx == b * n_kv and gz * dims >= d and (gz - 1) * dims < d
    owned = np.zeros((b, h, d), int)
    for x in range(gx):
        bb, kv = divmod(x, n_kv)
        for y in range(gy):
            for g in range(y * qg, min((y + 1) * qg, n_rep)):
                for z in range(gz):
                    owned[bb, kv * n_rep + g, z * dims:(z + 1) * dims] += 1
    assert (owned == 1).all()
    assert plan["smem"] <= tfa._SMEM_MAX
    # two blocks an SM at the production shapes (D = 128, DECODE_BLOCK keys)
    assert plan["smem"] <= tfa._SMEM_MAX // 2 or d != 128, plan["smem"]


@pytest.mark.parametrize("l,block,valid_len", [(512, 256, 480), (512, 256, 256), (512, 256, 257),
                                                (512, 256, None), (96, 256, 70), (64, 256, 64),
                                                (1280, 256, 1100), (1280, 256, 1)])
def test_k4_key_blocks_hold_every_valid_key(l, block, valid_len):
    """K4 visits key blocks [0, nvb) with nvb = ceil(valid_len / bl): every
    valid key of a mask with holes (a serving pool's) below valid_len lies
    in them, and a block past them would hold none."""
    bl, nvb = tfa._decode_blocks(l, block, valid_len)
    end = l if valid_len is None else valid_len
    rng = np.random.RandomState(l + end)
    mask = (rng.rand(3, l) < 0.7) & (np.arange(l)[None] < end)
    mask[:, 0] = True
    visited = np.arange(l) < nvb * bl
    assert not (mask & ~visited[None]).any()
    assert nvb <= l // bl and (nvb - 1) * bl < end


@pytest.fixture(scope="module")
def mlp_layer():
    cfg = dataclasses.replace(LLAMA_TINY, hidden_size=128, intermediate_size=384)
    return jax.device_get(jllm.init_layer(jax.random.PRNGKey(8), cfg))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_int4_plain_matches_jax_at_the_serving_pool(mlp_layer, act):
    mlp = jax.device_get(jquant.convert_mlp_int4(jax.tree_util.tree_map(jnp.asarray,
                                                                        mlp_layer["mlp"])))
    if act == "gelu":
        mlp = {"fc1": mlp["gate"], "fc2": mlp["down"]}
    x = np.random.RandomState(4).randn(4, 1, 128).astype(np.float32)
    want = jint4.fused_mlp_int4(jax.tree_util.tree_map(jnp.asarray, mlp), jnp.asarray(x), act)
    got = tint4.fused_mlp_int4(from_numpy_tree(mlp, "cpu"), torch.from_numpy(x), act)
    assert got.shape == (4, 1, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
