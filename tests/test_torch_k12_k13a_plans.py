"""K12's and K13a's launch plans (ops/fused_layer.fused_layer_tail_plan and
ops/int8_gemm.quantize_tokens_plan), which mirror csrc/fused_layer.cu and
csrc/int8_gemm.cu's quantize_rows, K12's o-projection products emulated bit
for bit, and K12's and K13a's plain versions against the JAX package.

- K12's plan: each phase's items, dealt grid-strided to min(2 x 132, the
  largest phase) blocks, cover every output once at the 7B (2, 4 and 32
  rows), 13B (2 and 16 rows) and demo decode steps and at chip_smoke's
  ragged shapes: the attention rows' (row, head, value dim), the o-proj's
  and gate/up's columns, the down pass's (tile, column), the sum's
  elements. Its shared memory fits two blocks an SM at D = 128
  and does not grow with the rows (but for one float a row; hn is held in
  it only where it fits), up to 64 rows at 7B and 13B; its scratch keeps the attention rows, x2 and y at
  rows 0-2 and room for hn, h and the partials.
- K13a's plan: every row is one block's, and every segment of a row one
  thread's, once, at K = 96, 100, 260, 1280 and 5120 in fp32 and bf16;
  16-value segments (16-byte loads and code stores) exactly where K % 16
  == 0, and a row held in at most 64 registers of raw values a thread.
- K12's o-projection: a numpy copy of the dp4a product loop it shares with
  K7 (dp4a_quads.cuh: the same byte-permute selectors, 128 quad lanes of
  each 16-column group, the lanes of a warp and then the 8 warps summed)
  over codes of +-127 and random ones equals the int64 product att8 @ o_wq
  at hd = 4096 (two items) and at a ragged hd = 120, and stays in int32.
- Plain versions against JAX at two ragged shapes each: K12's
  fused_layer_tail_reference against JAX's fused_layer_tail in Pallas
  interpret mode within 2 bf16 steps (2^-7) of the output's largest
  magnitude (tests/test_torch_fused_layer.py's bound and reason); K13a's
  codes and scales bit for bit against JAX's XLA quantization (the "a8"
  decisions both kernels state), and against JAX's quantize_tokens kernel
  in interpret mode: fp32 codes bit for bit and scales within 3e-7 (its
  scale takes the reciprocal another way: one last place), bf16 as
  tests/test_torch_int8_gemm.py compares them (interpret mode skips the
  rounding of x * inv to bf16, so a code at a tie may differ by one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.ops import flash_attention as jfa
from walkgpt_tpu.ops import fused_layer as jfl
from walkgpt_tpu.ops import int4 as jint4
from walkgpt_tpu.ops import int8_gemm as jg
from walkgpt_tpu.ops import quant as jquant
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.ops import flash_attention as tfa
from walkgpt_tpu_torch.ops import fused_layer as tfl
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.ops import int8_gemm as tg

SMS = 132                       # the H100's SMs
SMEM_PER_SM = 233472            # shared memory of an SM (228 KB)
SMEM_RESERVED = 1024            # the runtime's share a block
SMEM_MAX_BYTES = 232448         # the dynamic shared memory a block may have


def _llm_shape(cfg, rows, slots=512):
    c = cfg.llm
    return (rows, c.num_kv_heads, c.head_dim, slots, c.intermediate_size)


# (b, n_kv, d, l, i_dim, pack4): the decode steps of the repository's MHA
# configurations and chip_smoke's check_k12 shapes
K12_SHAPES = {
    "7B 2 rows": (*_llm_shape(tcfg.walkgpt_7b_config(), 2), True),
    "7B 4 rows": (*_llm_shape(tcfg.walkgpt_7b_config(), 4), True),
    "7B 32 rows": (*_llm_shape(tcfg.walkgpt_7b_config(), 32), True),
    "13B 2 rows": (*_llm_shape(tcfg.walkgpt_13b_config(), 2), True),
    "13B 16 rows": (*_llm_shape(tcfg.walkgpt_13b_config(), 16), True),
    "demo 2 rows": (*_llm_shape(tcfg.demo_config(), 2), True),
    "int8_flat gelu": (2, 8, 128, 256, 2816, False),
    "ragged": (3, 5, 24, 64, 384, True),
    "ragged int8 gelu": (2, 2, 8, 16, 96, False),
}


def _dealt(n_items, grid):
    """How many times each item is run when every block b takes b, b + grid, ..."""
    seen = np.zeros(n_items, int)
    for blk in range(grid):
        seen[blk::grid] += 1
    return seen


@pytest.mark.parametrize("name", list(K12_SHAPES))
def test_k12_plan_covers_every_item_of_every_phase_once(name):
    b, n_kv, d, l, i_dim, pack4 = K12_SHAPES[name]
    hd = n_kv * d
    plan = tfl.fused_layer_tail_plan(b, n_kv, d, l, i_dim, pack4)
    items, grid, dims = plan["items"], plan["blocks"], tfl.ATT_VALUE_DIMS
    assert grid == min(plan["blocks_per_sm"] * SMS, max(items.values()))
    for phase, n in items.items():
        assert (_dealt(n, grid) == 1).all(), phase
    # attention: item -> (row, kv head, value slice of K4's 64 dims)
    att = np.zeros((b, n_kv, -(-d // dims) * dims), int)
    n_sl = items["attention"] // (b * n_kv)
    for it in range(items["attention"]):
        bkv, sl = divmod(it, n_sl)
        r, kv = divmod(bkv, n_kv)
        att[r, kv, sl * dims:(sl + 1) * dims] += 1
    assert (att[..., :d] == 1).all()
    # o-proj and gate/up: item -> columns [cols * it, cols * (it + 1))
    for phase, width, cols in (("oproj", hd, tfl.OPROJ_COLS),
                               ("gate_up", i_dim, tint4.MLP4_GATE_UP_COLS)):
        own = np.zeros(items[phase] * cols, int)
        for it in range(items[phase]):
            own[it * cols:(it + 1) * cols] += 1
        assert (own[:width] == 1).all() and (items[phase] - 1) * cols < width, phase
    # down: item -> (tile, output columns of MLP4_DOWN_COLS)
    n_cols = -(-hd // tint4.MLP4_DOWN_COLS)
    down = np.zeros((plan["n_tiles"], n_cols * tint4.MLP4_DOWN_COLS), int)
    for it in range(items["down"]):
        t, c = divmod(it, n_cols)
        down[t, c * tint4.MLP4_DOWN_COLS:(c + 1) * tint4.MLP4_DOWN_COLS] += 1
    assert (down[:, :hd] == 1).all() and plan["n_tiles"] * plan["tile"] == i_dim
    assert items["sum"] * tfl.TAIL_THREADS >= b * hd > (items["sum"] - 1) * tfl.TAIL_THREADS
    # rows in passes of the plan's size, each row once
    rows = np.zeros(b, int)
    for m0 in range(0, b, plan["rows_per_pass"]):
        rows[m0:m0 + plan["rows_per_pass"]] += 1
    assert (rows == 1).all() and plan["rows_per_pass"] == (b if b <= 2 else 4)


@pytest.mark.parametrize("name", list(K12_SHAPES))
def test_k12_plan_memory_and_scratch(name):
    b, n_kv, d, l, i_dim, pack4 = K12_SHAPES[name]
    hd = n_kv * d
    plan = tfl.fused_layer_tail_plan(b, n_kv, d, l, i_dim, pack4)
    assert plan["smem"] == max(plan["smem_phases"].values()) <= SMEM_MAX_BYTES
    if d == 128:                 # two blocks an SM at the model paths' head width
        assert plan["blocks_per_sm"] == 2
        assert plan["blocks_per_sm"] * (plan["smem"] + SMEM_RESERVED) <= SMEM_PER_SM
    # the attention phase takes K4's chunk engine's memory (one query row, K4's slices)
    chunk = tfa.decode_chunk_plan(b, 1, n_kv, n_kv, d, plan["block"], True,
                                  tfl.ATT_VALUE_DIMS)
    assert plan["smem_phases"]["attention"] == chunk["smem"]
    rows = plan["scratch"]
    assert (rows["attention"], rows["x2"], rows["y"], rows["hn"]) == (0, 1, 2, 3)
    # h [b, i_dim] in bf16 fits its rows of [b, hd] fp32; then the partials
    assert (rows["parts"] - rows["h"]) * b * hd * 2 >= b * i_dim
    assert rows["rows"] - rows["parts"] == plan["n_tiles"]
    # the gate/up phase holds one float a row (1 / rms) beside K6's gate/up
    # memory, and hn [b, hd] in bf16 where that fits within the largest
    # phase's memory (up to 4 rows at 7B, 2 at 13B); else hn is formed as
    # each pass stages its rows
    hn = -(-(2 * b * hd) // 16) * 16 if plan["hn_held"] else 0
    assert plan["smem_phases"]["gate_up"] == 4 * (-(-(256 + b) // 4) * 4 + max(
        plan["rows_per_pass"] * hd, 2 * 64 * (plan["rows_per_pass"] * 32 + 4))) + hn
    held = {"7B 2 rows": True, "7B 4 rows": True, "7B 32 rows": False, "13B 2 rows": True,
            "13B 16 rows": False}
    if name in held:
        assert plan["hn_held"] == held[name]


@pytest.mark.parametrize("cfg", ["7B", "13B"])
def test_k12_plan_memory_does_not_grow_with_the_rows(cfg):
    """Up to 64 rows, K12 takes the same shared memory a block (the
    attention phase's) and two blocks an SM at the 7B and 13B steps: no
    batch the decode path can form makes its cooperative launch fail; hn
    is held in shared memory up to a batch and formed on the fly past it."""
    c = (tcfg.walkgpt_7b_config() if cfg == "7B" else tcfg.walkgpt_13b_config()).llm
    plans = [tfl.fused_layer_tail_plan(b, c.num_kv_heads, c.head_dim, 512, c.intermediate_size,
                                       True) for b in range(1, 65)]
    assert {p["smem"] for p in plans} == {plans[0]["smem_phases"]["attention"]}
    assert {p["blocks_per_sm"] for p in plans} == {2}
    assert all(p["blocks"] == 2 * SMS for p in plans)
    held = [p["hn_held"] for p in plans]
    assert held[0] and not held[-1] and held == sorted(held, reverse=True)


# (K, rows) of K13a's shapes: ragged, and ViT-H's fc1 / fc2 inputs
K13A_SHAPES = [(96, 37), (100, 37), (260, 130), (1280, 8192), (5120, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,m", K13A_SHAPES)
def test_k13a_plan_covers_every_row_and_segment_once(dtype, k, m):
    plan = tg.quantize_tokens_plan(m, k, dtype)
    seg, tpr, rpb = plan["segment"], plan["threads_per_row"], plan["rows_per_block"]
    assert seg == (16 if k % 16 == 0 else 4) and plan["segments"] * seg == k
    assert tpr in (32, 64, 128, 256) and rpb * tpr == tg.QUANT_THREADS
    # block blk takes rows blk * rpb ... + rpb - 1 (those below m)
    rows = np.zeros(plan["blocks"] * rpb, int)
    for blk in range(plan["blocks"]):
        rows[blk * rpb:(blk + 1) * rpb] += 1
    assert (rows[:m] == 1).all() and (plan["blocks"] - 1) * rpb < m
    # thread t of a row takes the segments t, t + tpr, ...: each once
    segs = np.zeros(plan["segments"], int)
    for t in range(tpr):
        held = range(t, plan["segments"], tpr)
        if plan["held"] == "registers":
            assert len(held) <= plan["segments_per_thread"]
        segs[list(held)] += 1
    assert (segs == 1).all()
    elem = 4 if dtype == torch.float32 else 2
    if plan["held"] == "registers":
        spt = plan["segments_per_thread"]
        assert spt & (spt - 1) == 0 and spt * seg * elem <= 256    # 64 registers of raw values
    # every shape of the repository is held in registers (read once)
    assert plan["held"] == "registers"
    # 16-byte loads where segments are 16 values; rows stay aligned for them
    if seg == 16:
        assert (k * elem) % 16 == 0 and k % 16 == 0
    else:
        assert (k * elem) % (4 * elem) == 0


def test_k13a_plan_reads_rows_past_a_block_twice():
    plan = tg.quantize_tokens_plan(4, 40000, torch.float32)
    assert plan["held"] == "two passes" and plan["threads_per_row"] == tg.QUANT_THREADS


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: result byte j is byte (s >> 4j) &
    7 of the 8 bytes of x (0-3) and y (4-7)."""
    b = np.concatenate([(x[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF,
                        (y[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF], -1)
    out = np.zeros(x.shape, np.uint32)
    for j in range(4):
        out |= b[..., (s >> (4 * j)) & 7].astype(np.uint32) << np.uint32(8 * j)
    return out


def _dp4a(a, b):
    """__dp4a with a zero accumulator: the dot of the 4 signed bytes of a and b."""
    sa = ((a[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF).astype(np.int64)
    sb = ((b[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF).astype(np.int64)
    sa, sb = np.where(sa > 127, sa - 256, sa), np.where(sb > 127, sb - 256, sb)
    return (sa * sb).sum(-1)


def _words(codes):
    """int8 [..., 4k] -> uint32 [..., k], byte j of word q = code 4q + j."""
    return np.ascontiguousarray(codes.astype(np.int8)).view(np.uint32)


def _oproj_item(att8, w, it):
    """K12's o-proj item `it` (csrc/fused_layer.cu oproj_phase): the int32
    sums of its OPROJ_COLS output columns for every row of att8 [B, hd]."""
    b, hd = att8.shape
    groups, lanes = tfl.OPROJ_COLS // 16, tfl.TAIL_THREADS // (tfl.OPROJ_COLS // 16)
    nq = hd // 4
    xw = _words(att8)                                        # [row, quad]
    out = np.zeros((b, tfl.OPROJ_COLS), np.int64)
    warp_sums = np.zeros((tfl.TAIL_THREADS // 32, groups, b, 16), np.int64)
    for tid in range(tfl.TAIL_THREADS):
        cg, ql = tid % groups, tid // groups
        col = it * tfl.OPROJ_COLS + cg * 16
        acc = np.zeros((b, 16), np.int64)
        if col < hd:
            for q in range(ql, nq, lanes):
                # 16 bytes of each of the quad's 4 rows from col (past hd: zeros)
                rows = np.zeros((4, 16), np.int8)
                n = min(16, hd - col)
                rows[:, :n] = w[4 * q:4 * q + 4, col:col + n]
                r = _words(rows)                             # [row of the quad, word]
                for j in range(4):
                    ab_lo = _byte_perm(r[0, j], r[1, j], 0x5140)
                    cd_lo = _byte_perm(r[2, j], r[3, j], 0x5140)
                    ab_hi = _byte_perm(r[0, j], r[1, j], 0x7362)
                    cd_hi = _byte_perm(r[2, j], r[3, j], 0x7362)
                    cols = [_byte_perm(ab_lo, cd_lo, 0x5410), _byte_perm(ab_lo, cd_lo, 0x7632),
                            _byte_perm(ab_hi, cd_hi, 0x5410), _byte_perm(ab_hi, cd_hi, 0x7632)]
                    for kk in range(4):
                        acc[:, 4 * j + kk] += _dp4a(cols[kk], xw[:, q])
                assert np.abs(acc).max() < 2 ** 31
        warp_sums[tid // 32, cg] += acc                      # the xor butterfly of a warp
    for cg in range(groups):
        out[:, cg * 16:(cg + 1) * 16] = warp_sums[:, cg].sum(0)
    return out


@pytest.mark.parametrize("hd,items", [(4096, (0, 127)), (120, (0, 3))])
def test_k12_oproj_dp4a_products_equal_the_int64_product(hd, items):
    rng = np.random.RandomState(hd)
    w = rng.randint(-127, 128, size=(hd, hd)).astype(np.int8)
    w[: hd // 2] = np.where(rng.rand(hd // 2, hd) < 0.5, -127, 127)
    w[:, 0] = np.where(rng.rand(hd) < 0.5, -127, 127)
    att8 = rng.randint(-127, 128, size=(2, hd)).astype(np.int8)
    att8[0] = np.where(w[:, 0] > 0, 127, -127)               # column 0 at its largest sum
    want = att8.astype(np.int64) @ w.astype(np.int64)
    for it in items:
        got = _oproj_item(att8, w, it)
        c0 = it * tfl.OPROJ_COLS
        n = min(tfl.OPROJ_COLS, hd - c0)
        np.testing.assert_array_equal(got[:, :n], want[:, c0:c0 + n])
        assert (got[:, n:] == 0).all() and np.abs(got).max() < 2 ** 31
    assert want[0, 0] == 127 * 127 * hd


def _tail_inputs(seed, b, n_kv, d, l, i_dim, pack4, gelu, lengths):
    """Numpy inputs of one fused layer tail (MHA) in the int4x format."""
    rng = np.random.RandomState(seed)
    hd = n_kv * d
    k = jnp.asarray(rng.randn(b, l, n_kv, d), jnp.float32)
    v = jnp.asarray(rng.randn(b, l, n_kv, d), jnp.float32)
    if pack4:
        (kq, ks), (vq, vs) = jllm._quant_pack4_flat(k), jllm._quant_pack4_flat(v)
        width = hd // 2
    else:
        (kq, ks), (vq, vs) = jllm._quant_rows(k, jnp.int8), jllm._quant_rows(v, jnp.int8)
        ks, vs = ks[..., 0], vs[..., 0]
        width = hd
    w = lambda *shape: jnp.asarray(rng.randn(*shape) * 0.05, jnp.float32)
    if gelu:
        mlp = {"fc1": jint4.quantize_weight4(w(hd, i_dim)), "fc2": jint4.pack_down4(w(i_dim, hd))}
    else:
        mlp = {"gate": jint4.quantize_weight4(w(hd, i_dim)),
               "up": jint4.quantize_weight4(w(hd, i_dim)), "down": jint4.pack_down4(w(i_dim, hd))}
    arrays = dict(
        x=jnp.asarray(rng.randn(b, hd) * 0.1, jnp.bfloat16),
        q=jnp.asarray(rng.randn(b, hd), jnp.float32),
        k=jnp.asarray(kq).reshape(b, l, width)[None], ks=jnp.asarray(ks).transpose(0, 2, 1)[None],
        v=jnp.asarray(vq).reshape(b, l, width)[None], vs=jnp.asarray(vs).transpose(0, 2, 1)[None],
        mask=jnp.arange(l)[None, :] < jnp.asarray(lengths)[:, None],
        o=jquant.convert_proj({"w": w(hd, hd)}, True),
        pn=jnp.asarray(1.0 + 0.1 * rng.randn(hd), jnp.float32), mlp=mlp)
    return jax.device_get(arrays), dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0,
                                        act="gelu" if gelu else "silu", norm_eps=1e-6, block=8)


@pytest.mark.parametrize("b,n_kv,d,l,i_dim,pack4,gelu,lengths,valid_len", [
    (3, 3, 8, 24, 160, True, False, [20, 9, 3], 20),
    (1, 2, 16, 16, 64, False, True, [13], None),
])
def test_k12_plain_matches_jax_interpret(b, n_kv, d, l, i_dim, pack4, gelu, lengths, valid_len):
    a, kw = _tail_inputs(b * 100 + d, b, n_kv, d, l, i_dim, pack4, gelu, lengths)
    j = jax.tree_util.tree_map(jnp.asarray, a)
    qb8, qs8 = jfa.banded_q8(j["q"], n_kv=n_kv, head_dim=d)
    want = np.asarray(jfl.fused_layer_tail(
        j["x"], qb8, qs8, j["k"], j["ks"], j["v"], j["vs"], j["mask"], j["o"], j["pn"],
        j["mlp"], valid_len=valid_len, **kw), np.float32)
    t = from_numpy_tree(a, "cpu")
    q8, qs = tfa.banded_q8(t["q"], n_kv=n_kv, head_dim=d)
    got = tfl.fused_layer_tail_reference(t["x"], q8, qs, t["k"], t["ks"], t["v"], t["vs"],
                                         t["mask"], t["o"], t["pn"], t["mlp"],
                                         valid_len=valid_len, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max(), err


def _xla_quant(x):
    """JAX's XLA quantization (core/nn.linear's a8 decisions)."""
    x = jnp.asarray(x)
    ax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    inv = (127.0 / jnp.maximum(ax.astype(jnp.float32), 1e-8)).astype(x.dtype)
    xq = jnp.clip(jnp.round(x * inv), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(1.0 / inv.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m,k", [(37, 100), (130, 260)])
def test_k13a_plain_matches_jax(dtype, m, k):
    rng = np.random.RandomState(m + k)
    x = rng.randn(m, k) * 3
    x[0, :5] = 0                                             # a row's head of zeros
    x = np.asarray(jnp.asarray(x, dtype))
    xt = from_numpy_tree(x, "cpu")
    xq, sx = tg.quantize_tokens_reference(xt)
    want_q, want_s = _xla_quant(x)
    np.testing.assert_array_equal(xq.numpy(), want_q)
    np.testing.assert_array_equal(sx.numpy(), want_s)
    jq, js = jg.quantize_tokens(jnp.asarray(x))              # the Pallas kernel, interpret mode
    if dtype == jnp.float32:
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(sx.numpy(), np.asarray(js), rtol=3e-7)
    else:
        xf = np.asarray(x, np.float32)
        step = np.abs(xf).max(-1, keepdims=True) / 127.0
        for q, s in ((xq.numpy(), sx.numpy()), (np.asarray(jq), np.asarray(js))):
            assert np.all(np.abs(q.astype(np.float32) * s - xf) <= step * 1.01 + 1e-6)
        assert np.mean(xq.numpy() != np.asarray(jq)) < 0.2
