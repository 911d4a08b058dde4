"""K11's and K13b's launch plans (ops/flash_attention.decode_attention_plan,
ops/int8_gemm.w8a8_gemm_plan), which mirror the grids of csrc/decode_flat.cuh
and csrc/int8_gemm.cu, and the index arithmetic of their kernels emulated
in numpy.

K11: at the fused_decode steps of the repository's configurations (1, 2
and 4 rows) every (row, head, value dim) is owned by exactly one block,
each block stages every key of every key block exactly once for its scores
and once for its value product (k tiles before v tiles, blocks in order),
and shared memory fits; the fp32 cache and the walk route take the walk.
The flat engine's scores take the butterflies of 8 keys together; emulated
on random fp32 partial sums, each key's total equals walk_block's
warp_sum bit for bit. K13b: at the four ViT-H products and the ragged
shapes, every output tile, row and column is owned by exactly one block,
the wgmma accumulator fragment covers its 64 x 128 tile once, the
transpose kernel's word packing gives w_q's transpose, and the first
design's route is taken exactly where TMA cannot go (K % 16 != 0). The
plain versions are held against JAX at the flat engine's ragged shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.ops import int8_gemm as jgemm
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import int8_gemm as tgemm

CONFIGS = {
    "7B": tcfg.walkgpt_7b_config().llm,
    "13B": tcfg.walkgpt_13b_config().llm,
    "1B": tcfg.flagship_1b_config().llm,
    "demo": tcfg.demo_config().llm,
}


def _k11_shapes():
    shapes = {n: (c.num_heads, c.num_kv_heads, c.head_dim) for n, c in CONFIGS.items()}
    shapes.update({"ragged GQA": (6, 3, 40), "D 20": (8, 2, 20), "n_rep 32": (32, 1, 64)})
    return shapes


@pytest.mark.parametrize("name", list(_k11_shapes()))
@pytest.mark.parametrize("b", [1, 2, 4])
def test_k11_plan_owns_every_output_and_key_once(name, b):
    h, n_kv, d = _k11_shapes()[name]
    l, bl = (512, 256) if d >= 64 else (96, 96)
    plan = tfa.decode_attention_plan(b, h, n_kv, d, l, bl)
    assert plan["engine"] == "flat"
    gx, gy, gz = plan["grid"]
    qg, n_rep, dims = plan["query_rows"], h // n_kv, plan["value_dims"]
    assert gx == b * n_kv and qg <= tfa.FLAT_QUERY_ROWS and dims == tfa.FLAT_VALUE_DIMS
    owned = np.zeros((b, h, d), int)
    for x in range(gx):
        bb, kv = divmod(x, n_kv)
        for y in range(gy):
            rows = range(y * qg, min((y + 1) * qg, n_rep))
            assert len(rows) * min(dims, d) <= 2 * 256       # two value chains a thread
            for g in rows:
                for z in range(gz):
                    owned[bb, kv * n_rep + g, z * dims:(z + 1) * dims] += 1
    assert (owned == 1).all()
    # every block's stream: per key block, each key once in k tiles, then once
    # in v tiles, blocks in order
    seen = {"k": np.zeros(l, int), "v": np.zeros(l, int)}
    last_block = -1
    for i, (kind, key0, nk) in enumerate(plan["tiles"]):
        assert 0 < nk <= tfa.FLAT_KEY_TILE
        jb = key0 // bl
        assert jb >= last_block and (key0 + nk - 1) // bl == jb
        if kind == "v":
            assert seen["k"][jb * bl:(jb + 1) * bl].all()     # the block's scores first
        else:
            assert not seen["v"][jb * bl:(jb + 1) * bl].any()
        seen[kind][key0:key0 + nk] += 1
        last_block = jb
    assert (seen["k"] == 1).all() and (seen["v"] == 1).all()
    assert plan["smem"] <= tfa._SMEM_MAX
    # two blocks an SM at the production head dim
    assert plan["smem"] <= tfa._SMEM_MAX // 2 or d != 128, plan["smem"]


@pytest.mark.parametrize("bf16,walk", [(False, False), (True, True), (False, True)])
def test_k11_fp32_cache_and_walk_route_take_the_walk(bf16, walk):
    plan = tfa.decode_attention_plan(2, 32, 32, 128, 512, 256, bf16, walk)
    assert plan["engine"] == "walk" and plan["grid"] == (64, 1, 1)
    assert plan["value_dims"] == 128 and plan["smem"] <= tfa._SMEM_MAX


def _warp_sum(v):
    """walk_block's warp_sum: v [32] fp32 per lane -> each lane's total."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _butterflies8(v8):
    """decode_flat.cuh's scores: v8 [32 lanes, 8 keys] fp32 -> the total each
    lane holds at the end, for key lane >> 2."""
    v = [v8[:, c].copy() for c in range(8)]
    lanes = np.arange(32)
    for o, n in ((16, 4), (8, 2), (4, 1)):
        up = (lanes & o) != 0
        new = []
        for c in range(n):
            send = np.where(up, v[c], v[c + n])
            keep = np.where(up, v[c + n], v[c])
            new.append((keep + send[lanes ^ o]).astype(np.float32))
        v = new
    t = v[0]
    for o in (2, 1):
        t = (t + t[lanes ^ o]).astype(np.float32)
    return t


@pytest.mark.parametrize("seed", range(6))
def test_k11_scores_butterflies_equal_the_walks_bit_for_bit(seed):
    rng = np.random.RandomState(seed)
    scale = 10.0 ** rng.uniform(-3, 3, size=(1, 8))
    v8 = (rng.randn(32, 8) * scale).astype(np.float32)
    v8[rng.rand(32, 8) < 0.1] = 0.0                  # lanes past D hold 0
    got = _butterflies8(v8)
    for lane in range(32):
        want = _warp_sum(v8[:, lane >> 2])
        assert (want == want[0]).all()                # every lane of the walk agrees
        assert got[lane].tobytes() == want[0].tobytes(), (lane, got[lane], want[0])


def _k13b_shapes():
    return {"ViT-H qkv": (9800, 1280, 3840), "ViT-H proj": (9800, 1280, 1280),
            "ViT-H fc1": (8192, 1280, 5120), "ViT-H fc2": (8192, 5120, 1280),
            "ragged": (37, 96, 20), "ragged bf16": (130, 256, 388),
            "K % 16 != 0": (37, 100, 20), "K % 16 != 0, wide": (130, 260, 388)}


@pytest.mark.parametrize("name", list(_k13b_shapes()))
def test_k13b_plan_owns_every_output_once(name):
    m, k, n = _k13b_shapes()[name]
    plan = tgemm.w8a8_gemm_plan(m, k, n)
    assert plan["route"] == ("wgmma" if k % 16 == 0 else "mma_sync")
    gx, gy = plan["grid"]
    bm, bn = plan["tile"]
    rows, cols = np.zeros(m, int), np.zeros(n, int)
    tiles = np.zeros((-(-m // bm), -(-n // bn)), int)
    for y in range(gy):
        rows[y * bm:(y + 1) * bm] += 1
        for x in range(gx):
            tiles[y, x] += 1
    for x in range(gx):
        cols[x * bn:(x + 1) * bn] += 1
    assert (rows == 1).all() and (cols == 1).all() and (tiles == 1).all()
    step = tgemm.TC_K_STEP if plan["route"] == "wgmma" else 64
    assert plan["k_steps"] * step >= k > (plan["k_steps"] - 1) * step
    assert plan["smem"] <= tgemm.SMEM_MAX
    if plan["route"] == "wgmma":
        # two blocks an SM, each with its 1 KB reserve
        assert 2 * (plan["smem"] + 1024) <= 233472
        assert plan["threads"] == 2 * 128 + 32


def test_k13b_accumulator_fragment_covers_its_tile_once():
    """The epilogue's map of a consumer warpgroup's 64 int32 registers a
    thread (m64n128 s32 fragment) onto the 64 x 128 tile."""
    owned = np.zeros((64, 128), int)
    for t in range(128):
        warp, lane = divmod(t, 32)
        for i in range(64):
            r = 16 * warp + lane // 4 + 8 * ((i // 2) % 2)
            c = 8 * (i // 4) + 2 * (lane % 4) + i % 2
            owned[r, c] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("k,n", [(96, 20), (256, 388), (128, 64), (64, 4)])
def test_k13b_transpose_word_packing_gives_the_transpose(k, n):
    """transpose_w: 64 x 64 byte tiles read as words of 4 columns, written
    as words of 4 rows of K (byte j of a word = row k + j)."""
    rng = np.random.RandomState(k + n)
    w = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    wt = np.zeros((n, k), np.int8)
    words = w.view(np.uint8).reshape(k, n // 4, 4).astype(np.uint32)
    words = (words << (8 * np.arange(4, dtype=np.uint32))).sum(-1).astype(np.uint32)  # [k, n/4]
    for k0 in range(0, k, 64):
        for n0 in range(0, n, 64):
            for nn in range(min(64, n - n0)):
                for c in range(min(16, (k - k0) // 4)):
                    word = 0
                    for j in range(4):
                        byte = (int(words[k0 + 4 * c + j, (n0 + nn) // 4]) >> (8 * (nn % 4))) & 255
                        word |= byte << (8 * j)
                    wt[n0 + nn, k0 + 4 * c:k0 + 4 * c + 4] = np.frombuffer(
                        np.uint32(word).tobytes(), np.int8)
    np.testing.assert_array_equal(wt, w.T)


@pytest.mark.parametrize("b,h,n_kv,d,l,valid", [(2, 6, 3, 40, 96, [90, 17]),
                                                (2, 8, 2, 24, 64, [64, 30])])
def test_k11_plain_matches_jax_at_the_ragged_shapes(b, h, n_kv, d, l, valid):
    rng = np.random.RandomState(l + d)
    q = rng.randn(b, h * d).astype(np.float32)
    k, v = (rng.randn(1, b, l, n_kv * d).astype(np.float32) for _ in range(2))
    mask = np.arange(l)[None] < np.asarray(valid)[:, None]
    want = jfa.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                n_kv=n_kv, layer=0)
    got = tfa.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(mask), n_kv=n_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("m,k,n,act", [(37, 96, 20, "gelu_tanh"), (37, 100, 20, None)])
def test_k13b_plain_matches_jax_on_both_routes_shapes(m, k, n, act):
    rng = np.random.RandomState(m + k)
    x = rng.randn(m, k).astype(np.float32)
    w_q = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    w_scale = (rng.rand(n) * 0.01 + 1e-3).astype(np.float32)
    bias = rng.randn(n).astype(np.float32) * 0.1
    want = jgemm.w8a8_gemm(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                           jnp.asarray(bias), act=act)
    got = tgemm.w8a8_gemm(torch.from_numpy(x), torch.from_numpy(w_q),
                          torch.from_numpy(w_scale), torch.from_numpy(bias), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
