"""K5's and K7's launch plans (ops/int4.int4_matmul_plan and
fused_mlp_int8_plan), which mirror the grids of csrc/int4_matmul.cu and
csrc/fused_mlp_int8.cu, K7's dp4a products emulated bit for bit, and K5's
and K7's plain versions against the JAX package at the serving pool's 4 rows
and the speculative chunk's 18.

The plans are checked for coverage at the shapes of the repository's
configurations: every output column, packed row or row quad and input row
is owned by exactly one block, lane and pass. K7's products are exact int32
sums of __dp4a over 4 weight rows transposed by byte permutes: a numpy copy
of that arithmetic (the same permute selectors) over codes of +-127 equals
the int64 product at H = 2048, 4096 and 5120 and stays inside int32. The
plain versions are held as tests/test_torch_quant_kernels.py holds them
(atol = rtol = 1e-5: K5 sums exact products in fp32 in another order; K7's
products are exact int32 and its codes agree).
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
from walkgpt_tpu_torch.ops import int4 as tint4

CONFIGS = {
    "7B": tcfg.walkgpt_7b_config().llm,
    "13B": tcfg.walkgpt_13b_config().llm,
    "1B": tcfg.flagship_1b_config().llm,
    "demo": tcfg.demo_config().llm,
}
ROWS = [1, 2, 4, 17, 18]
SMEM_MAX_BYTES = 232448     # the dynamic shared memory a block may have on the H100


def _passes(m, rows_per_pass):
    rows = np.zeros(m, int)
    for m0 in range(0, m, rows_per_pass):
        rows[m0:m0 + rows_per_pass] += 1
    return rows


def _k5_shapes():
    """(K, N) of the fused q/k/v and of the int4 lm_head (zero-padded to a
    multiple of 128 columns) of each configuration, and a ragged one."""
    shapes = {}
    for name, c in CONFIGS.items():
        shapes[f"{name} qkv4"] = (c.hidden_size, (c.num_heads + 2 * c.num_kv_heads) * c.head_dim)
        shapes[f"{name} lm_head"] = (c.hidden_size, -(-c.vocab_size // 128) * 128)
    shapes["ragged"] = (96, 384)
    return shapes


@pytest.mark.parametrize("name", list(_k5_shapes()))
@pytest.mark.parametrize("m", ROWS)
def test_k5_plan_covers_every_column_packed_row_and_row_once(name, m):
    k, n = _k5_shapes()[name]
    plan = tint4.int4_matmul_plan(m, k, n)
    # block b owns output columns [32 b, 32 b + 32)
    cols = np.zeros(plan["blocks"] * tint4.INT4_MM_COLS, int)
    for b in range(plan["blocks"]):
        cols[b * tint4.INT4_MM_COLS:(b + 1) * tint4.INT4_MM_COLS] += 1
    assert (cols[:n] == 1).all() and (plan["blocks"] - 1) * tint4.INT4_MM_COLS < n
    # row lane r sums the packed rows r, r + row_lanes, ... of K/2
    packed = np.zeros(k // 2, int)
    for r in range(plan["row_lanes"]):
        packed[r::plan["row_lanes"]] += 1
    assert (packed == 1).all()
    assert plan["rows_per_pass"] in (1, 2, 4) and (_passes(m, plan["rows_per_pass"]) == 1).all()
    # the staged rows and the lanes' partials both fit the block's shared memory
    rows = plan["rows_per_pass"]
    assert plan["smem_floats"] >= max(rows * k, plan["row_lanes"] * rows * tint4.INT4_MM_COLS)
    assert plan["smem_floats"] * 4 <= SMEM_MAX_BYTES


@pytest.mark.parametrize("name", list(CONFIGS) + ["ragged"])
@pytest.mark.parametrize("m", ROWS)
def test_k7_plan_covers_every_column_tile_quad_and_row_once(name, m):
    h, i_dim = (160, 96) if name == "ragged" else (CONFIGS[name].hidden_size,
                                                    CONFIGS[name].intermediate_size)
    plan = tint4.fused_mlp_int8_plan(m, h, i_dim)
    tile, n_tiles = plan["tile"], plan["n_tiles"]
    assert tile == tint4.tile_for(i_dim) and n_tiles * tile == i_dim and tile % 4 == 0
    # gate/up: block k owns columns [32 k, 32 k + 32) of I; in each group of
    # 16 columns, lane l sums the row quads l, l + lanes, ... of H
    cols = np.zeros(plan["gate_up_blocks"] * tint4.MLP8_GATE_UP_COLS, int)
    for k in range(plan["gate_up_blocks"]):
        cols[k * tint4.MLP8_GATE_UP_COLS:(k + 1) * tint4.MLP8_GATE_UP_COLS] += 1
    assert (cols[:i_dim] == 1).all()
    assert (plan["gate_up_blocks"] - 1) * tint4.MLP8_GATE_UP_COLS < i_dim
    rows_h = np.zeros(h, int)
    for lane in range(tint4.MLP8_GATE_UP_QUAD_LANES):
        for q in range(lane, h // 4, tint4.MLP8_GATE_UP_QUAD_LANES):
            rows_h[4 * q:4 * q + 4] += 1
    assert h % 4 == 0 and (rows_h == 1).all()
    # down: block (s, t) owns tile t's rows and output columns [256 s, 256 s + 256);
    # lane l sums the tile's row quads l, l + lanes, ...
    n_slices = plan["down_blocks"] // n_tiles
    assert n_slices * n_tiles == plan["down_blocks"]
    owned = np.zeros((n_tiles, n_slices * tint4.MLP8_DOWN_COLS), int)
    for t in range(n_tiles):
        for s in range(n_slices):
            owned[t, s * tint4.MLP8_DOWN_COLS:(s + 1) * tint4.MLP8_DOWN_COLS] += 1
    assert (owned[:, :h] == 1).all() and (n_slices - 1) * tint4.MLP8_DOWN_COLS < h
    rows_t = np.zeros(tile, int)
    for lane in range(tint4.MLP8_DOWN_QUAD_LANES):
        for q in range(lane, tile // 4, tint4.MLP8_DOWN_QUAD_LANES):
            rows_t[4 * q:4 * q + 4] += 1
    assert (rows_t == 1).all()
    assert plan["rows_per_pass"] in (1, 2, 4) and (_passes(m, plan["rows_per_pass"]) == 1).all()
    # act [m, I], then the tiles' partials, 16-byte aligned
    assert plan["parts_offset"] == m * i_dim and plan["parts_offset"] % 4 == 0
    assert plan["scratch_floats"] == plan["parts_offset"] + n_tiles * m * h


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: result byte j is byte (s >> 4j) &
    7 of the 8 bytes of x (0-3) and y (4-7)."""
    b = np.concatenate([(x[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF,
                        (y[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF], -1)
    out = np.zeros(x.shape, np.uint32)
    for j in range(4):
        out |= b[..., (s >> (4 * j)) & 7].astype(np.uint32) << np.uint32(8 * j)
    return out


def _dp4a(a, b, c):
    """__dp4a: c + the dot of the 4 signed bytes of a and of b (int64 here)."""
    sa = ((a[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF).astype(np.int64)
    sb = ((b[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF).astype(np.int64)
    sa, sb = np.where(sa > 127, sa - 256, sa), np.where(sb > 127, sb - 256, sb)
    return c + (sa * sb).sum(-1)


def _words(codes):
    """int8 [..., 4k] -> uint32 [..., k], byte j of word q = code 4q + j."""
    return np.ascontiguousarray(codes.astype(np.int8)).view(np.uint32)


@pytest.mark.parametrize("h", [2048, 4096, 5120])
def test_k7_dp4a_products_equal_the_int64_product(h):
    """csrc/fused_mlp_int8.cu's dp4a_quad and the lane split of a gate/up
    block, on one group of 16 columns: codes of +-127 (the extremes) and
    random ones."""
    rng = np.random.RandomState(h)
    w = rng.randint(-127, 128, size=(h, 16))
    w[: h // 2] = np.where(rng.rand(h // 2, 16) < 0.5, -127, 127)
    w[:, 0] = np.where(rng.rand(h) < 0.5, -127, 127)
    x = rng.randint(-127, 128, size=(2, h))
    x[0] = np.where(w[:, 0] > 0, 127, -127)                 # column 0 at its largest sum
    rows = _words(w).reshape(h // 4, 4, 4)   # [quad, row of the quad, word of 4 columns]
    xw = _words(x)                            # [x row, quad]: the codes of the quad's rows
    contrib = np.zeros((h // 4, 2, 16), np.int64)            # each quad's dp4a sums
    for j in range(4):
        r = [rows[:, i, j] for i in range(4)]
        ab_lo, cd_lo = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[2], r[3], 0x5140)
        ab_hi, cd_hi = _byte_perm(r[0], r[1], 0x7362), _byte_perm(r[2], r[3], 0x7362)
        col = [_byte_perm(ab_lo, cd_lo, 0x5410), _byte_perm(ab_lo, cd_lo, 0x7632),
               _byte_perm(ab_hi, cd_hi, 0x5410), _byte_perm(ab_hi, cd_hi, 0x7632)]
        for kk in range(4):
            for m in range(2):
                contrib[:, m, 4 * j + kk] = _dp4a(col[kk], xw[m], 0)
    # lane l sums the quads l, l + lanes, ...: its int32 partial never overflows
    lanes = tint4.MLP8_GATE_UP_QUAD_LANES
    per_lane = contrib.reshape(-1, lanes, 2, 16).sum(0)
    assert np.abs(np.cumsum(contrib.reshape(-1, lanes, 2, 16), 0)).max() < 2 ** 31
    total = per_lane.sum(0)
    np.testing.assert_array_equal(total, x.astype(np.int64) @ w.astype(np.int64))
    assert total[0, 0] == 127 * 127 * h and np.abs(total).max() < 2 ** 31


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def mlp_layer():
    cfg = dataclasses.replace(LLAMA_TINY, hidden_size=128, intermediate_size=384)
    return jax.device_get(jllm.init_layer(jax.random.PRNGKey(8), cfg))


@pytest.mark.parametrize("rows", [4, 18])
def test_int4_matmul_pallas_plain_matches_jax_at_pool_and_chunk_rows(mlp_layer, rows):
    qkv = jax.device_get(jquant.convert_attn_int4(_j(mlp_layer["attn"]), True))["qkv4"]
    x = np.random.RandomState(rows + 20).randn(rows, 1, 128).astype(np.float32)
    want = jint4.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(qkv["w_p4"]),
                                    jnp.asarray(qkv["w_scale"]))
    qt = from_numpy_tree(qkv, "cpu")
    got = tint4.int4_matmul_pallas(torch.from_numpy(x), qt["w_p4"], qt["w_scale"])
    assert got.shape == (rows, 1, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [4, 18])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_int8_plain_matches_jax_at_pool_and_chunk_rows(mlp_layer, rows, act):
    mlp = {k: jquant.convert_proj(v, True) for k, v in _j(mlp_layer["mlp"]).items()}
    if act == "gelu":
        mlp = {"fc1": mlp["gate"], "fc2": mlp["down"]}
    mlp = jax.device_get(mlp)
    x = np.random.RandomState(rows + 30).randn(rows, 1, 128).astype(np.float32)
    want = jint4.fused_mlp_int8(_j(mlp), jnp.asarray(x), act)
    got = tint4.fused_mlp_int8(from_numpy_tree(mlp, "cpu"), torch.from_numpy(x), act)
    assert got.shape == (rows, 1, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
