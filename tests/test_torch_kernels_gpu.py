"""The CUDA kernels K1-K8, K10-K13a/b and the backward kernels K1b-K3b, K10b
against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/ on first use) and
skip elsewhere. They import nothing of JAX, so they run on a machine without
it; tests/conftest.py imports jax, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py

Tolerances: fp32 atol = rtol = 1e-4 with TF32 off (same arithmetic, another
summation order and the kernel's online softmax); bf16: the kernel and the
plain version round at the same points, so outputs agree to about one bf16
rounding step of the output (atol 2e-2, mean-abs 2e-3). K4 and K6 round
inside (p and alpha, the intermediate h) to bf16, and K7 requantizes its
intermediate to int8, so a last-place difference before such a point moves
one term by a bf16 step or one code: for K4-K8 the errors are taken
relative to the output's largest magnitude (at least 1): 1e-3 in fp32, the
bf16 bounds above in bf16. K8's token t and K4 at the same position keep the
same rounding points in the same block order over the same cache: equal bit
for bit. K5's and K6's sums run in an order fixed by the shapes and K7's
are exact integers: a row of a batch equals that row called alone, and two
calls give the same bits. K11 (fp32
online softmax, p rounded to the cache's type) takes the K1-K3 bounds. The
backward kernels K1b-K3b sum over up to N terms per gradient in another
order than the plain backward: fp32 atol = rtol = 1e-4; bf16 outputs
relative to their largest magnitude (at least 1), 2e-2 max and 2e-3 mean,
one bf16 rounding step of the gradient. K12 rounds x2, the normed row and the MLP's
intermediate to bf16 inside, in fp32 models too: its output takes the bf16
bounds relative to its largest magnitude, whatever x's dtype, and its
attention rows K4's fp32 bound, their o-proj codes within one of the
plain rows' and at most 1% of them moved; its MLP phases run K6's passes,
so its tiles' partials equal K6's on its own normed rows bit for bit, up
to 32 rows at 7B and 16 at 13B; fused_layer_tail_plan equals the launch
the runtime plans (fused_layer_tail_info).
K13a's codes and scales are the plain
version's bit for bit (same fp32 division, same rounding to x's dtype, same
half-to-even round), and quantize_tokens_plan equals the launch its C
entry plans (quantize_tokens_info); K13b's int32 sums are exact and its epilogue is the
plain version's operation for operation, so its outputs agree to erff /
tanhf last places: rtol 1e-6 in fp32, one bf16 step (2^-8) in bf16.
K11's bf16 route (csrc/decode_flat.cuh) repeats the walk's expressions in
the same order, and K13b's tensor-core route (three launches, wgmma) has
the first design's exact int32 sums, codes and epilogue: each equals its
other route bit for bit.
K10 and K10b take K2's and K2b's bounds (a bf16 output of either, or a
bf16 q with fp32 rel tables, the bf16 ones); K10 runs K2's engine with the
same logits, so on repacked values its out and lse equal K2's bit for bit.
K1, K1b, K2, K2b, K3, K3b, K10 and K10b take their route by dtype: fp32
the CUDA-core engines, bf16 the tensor-core ones (bf16 products with fp32
sums at the same rounding points; K1's p . v and K1b's, K2b's and K3b's
dv, dk and dq take p and ds split into two bf16 parts, about 16 bits), both
within the bounds above; K1b, K2b and K3b are deterministic in both, and
K10b's bf16 gradients equal K2b's on repacked values bit for bit. K1's bf16 route gives a row
that sees no valid key the mean of v over the keys of the tiles it visits
(the CUDA-core engine's function), finite. K4 runs the chunk engine of K8
(all modes but the int8 value product), which keeps the walk's rounding
points in the same order: it equals K4 on the walk route bit for bit.
K1, K4, K5 and K6 have fp16 routes: K1 and K5 round their output to fp16
once (one fp16 step, 4e-3 max and 4e-4 mean relative to the output's
largest magnitude), K4 and K6 round to bf16 inside as in bf16 (the bf16
bounds); K4's fp16 chunk engine equals its walk bit for bit. The decode
kernels K4, K8, K11 take blocks of 128, 256 and 512 keys within their
bounds (K4 and K11 equal to their walks bit for bit).
"""
import pytest
import torch

from walkgpt_tpu_torch.core.nn import int8_matmul
from walkgpt_tpu_torch.models import llm
from walkgpt_tpu_torch.ops import flash_attention as fa
from walkgpt_tpu_torch.ops import fused_layer, int4, int8_gemm, quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        err = (got - want).abs()
        assert err.max() <= 2e-2 and err.mean() <= 2e-3, (err.max(), err.mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,causal", [(37, 16, True), (130, 20, True), (70, 128, True),
                                        (65, 64, False)])
def test_k1_kernel_matches_plain(dev, dtype, n, d, causal):
    g = torch.Generator(device=dev).manual_seed(n * d)
    q, k, v = (torch.randn(2, 3, n, d, generator=g, device=dev).to(dtype) for _ in range(3))
    kv = torch.arange(n, device=dev)[None] < torch.tensor([[n], [n - 11]], device=dev)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal, kv, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal, kv)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("n,d", [(70, 128), (37, 20)])
def test_k1_bf16_rows_without_a_valid_key(dev, n, d):
    g = torch.Generator(device=dev).manual_seed(n + d)
    q, k, v = (torch.randn(2, 2, n, d, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kv = torch.ones(2, n, dtype=torch.bool, device=dev)
    kv[1, :5] = False                       # row 1's queries 0 .. 4 see no key
    out, lse = fa.flash_attention(q, k, v, True, kv, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    mean = v[1, :, :min(n, 64)].float().mean(1, keepdim=True)
    assert (out[1, :, :5].float() - mean).abs().max() <= 2e-2
    assert (lse[1, :, :5] <= -1e29).all()
    ref = fa.flash_attention_reference(q, k, v, True, kv)[0]
    _close(out[:, :, 5:], ref[:, :, 5:], torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,d,h", [(2, 16, 2), (3, 20, 3), (14, 80, 2)])
def test_k2_kernel_matches_plain(dev, dtype, ws, d, h):
    g = torch.Generator(device=dev).manual_seed(ws * d)
    bw, t = 5, ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=g, device=dev).to(dtype)
    rel = torch.randn(bw, t, 2 * h * ws, generator=g, device=dev).to(dtype)
    out, lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.sam_window_attention_packed_reference(qkv, rel, h, d, ws)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


# K2's (and K10's) bf16 route runs the tensor-core engine: ragged tiles at
# every T (196 = 3 x 64 + 4, 49, 9), D a multiple of 16, of 8 only, and of
# neither (2-byte loads), one image's 25 windows at ViT-H's 16 heads
@pytest.mark.parametrize("ws", [14, 7, 3])
@pytest.mark.parametrize("d", [80, 64, 20])
def test_k2_bf16_tensor_core_route_matches_plain(dev, ws, d):
    g = torch.Generator(device=dev).manual_seed(ws * d + 9)
    bw, h, t = 25, 16 if d == 80 else 3, ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=g, device=dev).to(torch.bfloat16)
    rel = torch.randn(bw, t, 2 * h * ws, generator=g, device=dev).to(torch.bfloat16)
    before = fa.sam_window_attention_packed.launches
    out, lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    torch.cuda.synchronize()
    assert fa.sam_window_attention_packed.launches == before + 1
    ref, ref_lse = fa.sam_window_attention_packed_reference(qkv, rel, h, d, ws)
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


# K3 and K3b: each dtype takes its own route (fp32 the CUDA-core engine,
# bf16 the tensor-core one); (12, 40, 64) has key tiles that cut grid rows,
# (64, 64, 80) is the production grid (one key tile per grid row), (16, 64,
# 40) and (8, 128, 64) whole grid rows per key tile off the production
# instantiation (D % 16 != 0; gw = 128), all four at one image
K3_SHAPES = [(4, 4, 16), (5, 7, 20), (16, 16, 80), (12, 40, 64), (64, 64, 80), (16, 64, 40),
             (8, 128, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,d", K3_SHAPES)
def test_k3_kernel_matches_plain(dev, dtype, gh, gw, d):
    g = torch.Generator(device=dev).manual_seed(gh * gw + d)
    b, h, n = 2 if gh * gw <= 256 else 1, 2, gh * gw
    # q, k, v as strided head views of one projection, as the encoder passes them
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev).to(dtype)
    q, k, v = (x.reshape(b, n, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    rel_h = torch.randn(b, h, n, gh, generator=g, device=dev).to(dtype)
    rel_w = torch.randn(b, h, n, gw, generator=g, device=dev).to(dtype)
    out, lse = fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.sam_flash_attention_reference(q, k, v, rel_h, rel_w, (gh, gw))
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def test_wrappers_raise_instead_of_falling_back(dev):
    before = fa.flash_attention.launches
    q = torch.zeros(1, 1, 4, 200, device=dev)              # D > 128: no kernel
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, True, None)
    with pytest.raises(ValueError):                         # mixed dtypes: no kernel
        fa.flash_attention(q.half(), q.bfloat16(), q.half(), True, None)
    assert fa.flash_attention.launches == before


def _close_scaled(got, want, dtype):
    """Errors relative to the output's largest magnitude (at least 1): 1e-3
    in fp32; 2e-2 (max) and 2e-3 (mean) in bf16."""
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    err = (got - want).abs() / scale
    if dtype == torch.float32:
        assert err.max() <= 1e-3, err.max()
    else:
        assert err.max() <= 2e-2 and err.mean() <= 2e-3, (err.max(), err.mean())


def _flat_cache(dev, g, b, l, n_kv, d, pack4):
    k = torch.randn(2, b, l, n_kv, d, generator=g, device=dev)
    v = torch.randn(2, b, l, n_kv, d, generator=g, device=dev)
    quant_fn = llm._quant_pack4_flat if pack4 else (
        lambda x: (lambda q, s: (q.flatten(-2), s))(*llm._quant_rows(x)))
    (kq, ks), (vq, vs) = quant_fn(k), quant_fn(v)
    return kq, ks.transpose(2, 3).contiguous(), vq, vs.transpose(2, 3).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n_kv,d,l,block,pack4", [
    (4, 2, 16, 48, 16, False), (4, 4, 20, 64, 32, True), (6, 3, 8, 24, 8, True),
    (32, 32, 128, 512, 256, True), (16, 16, 128, 512, 256, False)])
@pytest.mark.parametrize("qdot8,pv8", [(True, False), (False, False), (True, True)])
def test_k4_kernel_matches_plain(dev, dtype, h, n_kv, d, l, block, pack4, qdot8, pv8):
    g = torch.Generator(device=dev).manual_seed(h * d + l)
    b = 2
    kq, ks, vq, vs = _flat_cache(dev, g, b, l, n_kv, d, pack4)
    q = torch.randn(b, h * d, generator=g, device=dev).to(dtype)
    lens = torch.tensor([[l * 3 // 4], [l // 2 + 1]], device=dev)
    mask = torch.arange(l, device=dev)[None] < lens
    mask[0, 1] = False
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=block,
              valid_len=l * 3 // 4, qdot_int8=qdot8, pv_int8=pv8)
    before = fa.decode_attention_q.launches
    out = fa.decode_attention_q(q, kq, ks, vq, vs, mask, **kw)
    torch.cuda.synchronize()
    assert fa.decode_attention_q.launches == before + 1
    _close_scaled(out, fa.decode_attention_q_reference(q, kq, ks, vq, vs, mask, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n_kv,d,l,block,pack4", [
    (4, 2, 16, 48, 16, False), (4, 4, 20, 64, 32, True), (6, 3, 8, 24, 8, True),
    (6, 3, 40, 96, 256, True), (32, 32, 128, 512, 256, True), (16, 16, 128, 512, 256, False)])
@pytest.mark.parametrize("qdot8", [True, False])
def test_k4_chunk_engine_equals_the_walk(dev, dtype, h, n_kv, d, l, block, pack4, qdot8):
    g = torch.Generator(device=dev).manual_seed(h * d + l + 1)
    b = 3
    kq, ks, vq, vs = _flat_cache(dev, g, b, l, n_kv, d, pack4)
    q = torch.randn(b, h * d, generator=g, device=dev).to(dtype)
    valid = l * 3 // 4
    mask = (torch.rand(b, l, generator=g, device=dev) < 0.8) & (
        torch.arange(l, device=dev)[None] < valid)
    mask[:, 0] = True
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=block, valid_len=valid,
              qdot_int8=qdot8)
    out = fa.decode_attention_q(q, kq, ks, vq, vs, mask, **kw)
    walk = fa.decode_attention_q_walk(q, kq, ks, vq, vs, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, walk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (2, 4096, 12288), (5, 96, 384), (2, 4096, 32128),
                                   (4, 4096, 12288), (18, 4096, 12288), (2, 5120, 15360)])
def test_k5_kernel_matches_plain(dev, dtype, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    w = int4.quantize_weight4(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    before = int4.int4_matmul_pallas.launches
    out = int4.int4_matmul_pallas(x, w["w_p4"], w["w_scale"])
    torch.cuda.synchronize()
    assert int4.int4_matmul_pallas.launches == before + 1
    _close_scaled(out, int4.int4_matmul_pallas_reference(x, w["w_p4"], w["w_scale"]), dtype)


def _mlp(dev, g, h, i_dim, act, fmt):
    ws = {n: torch.randn(*shape, generator=g, device=dev) * 0.05 for n, shape in
          (("gate", (h, i_dim)), ("up", (h, i_dim)), ("down", (i_dim, h)))}
    if fmt == "int4":
        p = quant.convert_mlp_int4({n: {"w": w} for n, w in ws.items()})
    else:
        p = {n: quant.convert_proj({"w": w}, True) for n, w in ws.items()}
    return p if act == "silu" else {"fc1": p["gate"], "fc2": p["down"]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("m,h,i_dim,act", [(1, 64, 96, "silu"), (5, 128, 384, "gelu"),
                                           (2, 4096, 11008, "silu"), (2, 2048, 5504, "silu"),
                                           (1, 4096, 11008, "silu"), (4, 4096, 11008, "silu"),
                                           (17, 4096, 11008, "silu"),
                                           (256, 4096, 11008, "silu"),
                                           (18, 2048, 5504, "silu"), (3, 160, 200, "gelu")])
def test_k6_k7_kernels_match_plain(dev, dtype, fmt, m, h, i_dim, act):
    g = torch.Generator(device=dev).manual_seed(m + h + i_dim)
    p = _mlp(dev, g, h, i_dim, act, fmt)
    x = torch.randn(m, 1, h, generator=g, device=dev).to(dtype)
    fn, ref = ((int4.fused_mlp_int4, int4.fused_mlp_int4_reference) if fmt == "int4"
               else (int4.fused_mlp_int8, int4.fused_mlp_int8_reference))
    before = fn.launches
    out = fn(p, x, act)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _close_scaled(out, ref(p, x, act), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_k6_rows_are_independent_and_deterministic(dev, dtype, act):
    """Row r of a 4-row call (the 7B server's pool) equals row r called
    alone, bit for bit, and a second call gives the same bits: the sums'
    order depends on the shapes only."""
    g = torch.Generator(device=dev).manual_seed(4)
    p = _mlp(dev, g, 4096, 11008, act, "int4")
    x = torch.randn(4, 1, 4096, generator=g, device=dev).to(dtype)
    out = int4.fused_mlp_int4(p, x, act)
    assert torch.equal(out, int4.fused_mlp_int4(p, x, act))
    for r in range(4):
        assert torch.equal(out[r], int4.fused_mlp_int4(p, x[r:r + 1], act)[0]), r
    assert torch.equal(out[1:3], int4.fused_mlp_int4(p, x[1:3], act))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_k5_k7_rows_are_independent_and_deterministic(dev, dtype, act):
    """As K6's: row r of a 4-row call equals row r called alone, bit for
    bit, and a second call gives the same bits (K5 at the 7B qkv4, K7 at the
    1B MLP)."""
    g = torch.Generator(device=dev).manual_seed(5)
    w = int4.quantize_weight4(torch.randn(4096, 12288, generator=g, device=dev) * 0.02)
    x = torch.randn(4, 4096, generator=g, device=dev).to(dtype)
    k5 = lambda r: int4.int4_matmul_pallas(x[r], w["w_p4"], w["w_scale"])
    p = _mlp(dev, g, 2048, 5504, act, "int8")
    x8 = torch.randn(4, 1, 2048, generator=g, device=dev).to(dtype)
    k7 = lambda r: int4.fused_mlp_int8(p, x8[r], act)
    for fn in (k5, k7):
        out = fn(slice(0, 4))
        assert torch.equal(out, fn(slice(0, 4)))
        for r in range(4):
            assert torch.equal(out[r], fn(slice(r, r + 1))[0]), r
        assert torch.equal(out[1:3], fn(slice(1, 3)))


@pytest.mark.parametrize("m,k,n", [(2, 4096, 4096), (2, 2048, 6144), (9800, 1280, 3840),
                                   (27, 32, 512),
                                   (3, 20, 12)])
def test_int8_product_on_the_card_is_exact(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    assert torch.equal(int8_matmul(a, b).cpu(), a.cpu().int() @ b.cpu().int())


def test_quantized_wrappers_raise_instead_of_falling_back(dev):
    counts = [f.launches for f in (fa.decode_attention_q, *int4.KERNELS)]
    w = int4.quantize_weight4(torch.randn(64, 128, device=dev))
    with pytest.raises(ValueError):                         # fp64: no kernel
        int4.int4_matmul_pallas(torch.zeros(2, 64, device=dev).double(), w["w_p4"],
                                w["w_scale"])
    kq = torch.zeros(1, 1, 256, 32, dtype=torch.int8, device=dev)
    ks = torch.zeros(1, 1, 2, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):                         # fp32 scales: no kernel
        fa.decode_attention_q(torch.zeros(1, 32, device=dev), kq, ks.float(), kq, ks.float(),
                              torch.ones(1, 256, dtype=torch.bool, device=dev), n_kv=2,
                              head_dim=16)
    p = _mlp(dev, torch.Generator(device=dev).manual_seed(0), 64, 96, "silu", "int8")
    with pytest.raises(ValueError):                         # fp16: no kernel
        int4.fused_mlp_int8(p, torch.zeros(1, 1, 64, device=dev).half(), "silu")
    assert [f.launches for f in (fa.decode_attention_q, *int4.KERNELS)] == counts


def _chunk_inputs(dev, g, dtype, b, tc, h, n_kv, d, l, pack4, cl):
    kq, ks, vq, vs = _flat_cache(dev, g, b, l, n_kv, d, pack4)
    q = torch.randn(b, tc, h * d, generator=g, device=dev).to(dtype)
    return q, kq, ks, vq, vs, torch.tensor(cl, device=dev)


K8_SHAPES = [  # h, n_kv, d, l, block, pack4, tc, cache_len per row
    (4, 2, 16, 48, 16, False, 4, [30, 7]), (4, 4, 20, 64, 32, True, 1, [40, 63]),
    (6, 3, 8, 24, 8, True, 5, [11, 0]), (16, 2, 16, 64, 16, True, 16, [33, 48]),
    (32, 32, 128, 512, 256, True, 9, [440, 375]), (16, 16, 128, 512, 256, False, 9, [440, 375]),
    (32, 32, 128, 512, 256, True, 9, [0, 503])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n_kv,d,l,block,pack4,tc,cl", K8_SHAPES)
@pytest.mark.parametrize("qdot8", [True, False])
def test_k8_kernel_matches_plain(dev, dtype, h, n_kv, d, l, block, pack4, tc, cl, qdot8):
    g = torch.Generator(device=dev).manual_seed(h * d + l + tc)
    q, kq, ks, vq, vs, cache_len = _chunk_inputs(dev, g, dtype, 2, tc, h, n_kv, d, l, pack4, cl)
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=block, qdot_int8=qdot8)
    before = fa.decode_attention_q_chunk.launches
    out = fa.decode_attention_q_chunk(q, kq, ks, vq, vs, cache_len, **kw)
    torch.cuda.synchronize()
    assert fa.decode_attention_q_chunk.launches == before + 1
    _close_scaled(out, fa.decode_attention_q_chunk_reference(q, kq, ks, vq, vs, cache_len, **kw),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n_kv,d,l,block,pack4,tc,cl", K8_SHAPES)
@pytest.mark.parametrize("qdot8", [True, False])
def test_k8_token_equals_k4_at_its_position(dev, dtype, h, n_kv, d, l, block, pack4, tc, cl,
                                            qdot8):
    g = torch.Generator(device=dev).manual_seed(h * d + l + tc + 1)
    q, kq, ks, vq, vs, cache_len = _chunk_inputs(dev, g, dtype, 2, tc, h, n_kv, d, l, pack4, cl)
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, block=block, qdot_int8=qdot8)
    out = fa.decode_attention_q_chunk(q, kq, ks, vq, vs, cache_len, **kw)
    pos = torch.arange(l, device=dev)[None]
    for t in range(tc):
        end = cache_len[:, None] + t + 1
        step = fa.decode_attention_q(q[:, t].contiguous(), kq, ks, vq, vs, pos < end,
                                     valid_len=int(end.max()), **kw)
        assert torch.equal(out[:, t], step), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n_kv,d,l,block", [(4, 2, 8, 16, 8), (6, 3, 20, 96, 32),
                                              (32, 32, 128, 512, 256), (16, 2, 64, 256, 64)])
def test_k11_kernel_matches_plain(dev, dtype, h, n_kv, d, l, block):
    g = torch.Generator(device=dev).manual_seed(h * d + l)
    b = 2
    q = torch.randn(b, h * d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, b, l, n_kv * d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, b, l, n_kv * d, generator=g, device=dev).to(dtype)
    mask = torch.arange(l, device=dev)[None] < torch.tensor([[l * 15 // 16], [l // 3]], device=dev)
    mask[0, 2] = False
    before = fa.decode_attention.launches
    out = fa.decode_attention(q, k, v, mask, n_kv=n_kv, layer=1, block=block)
    torch.cuda.synchronize()
    assert fa.decode_attention.launches == before + 1
    _close(out, fa.decode_attention_reference(q, k, v, mask, n_kv=n_kv, layer=1, block=block),
           dtype)


@pytest.mark.parametrize("h,n_kv,d,l,block", [(4, 2, 8, 16, 8), (6, 3, 20, 96, 32),
                                              (32, 32, 128, 512, 256), (16, 2, 64, 256, 64),
                                              (32, 1, 64, 768, 256), (6, 3, 40, 96, 256)])
def test_k11_flat_engine_equals_the_walk(dev, h, n_kv, d, l, block):
    g = torch.Generator(device=dev).manual_seed(h * d + l + 1)
    b = 3
    q = torch.randn(b, h * d, generator=g, device=dev).bfloat16()
    k = torch.randn(2, b, l, n_kv * d, generator=g, device=dev).bfloat16()
    v = torch.randn(2, b, l, n_kv * d, generator=g, device=dev).bfloat16()
    mask = torch.rand(b, l, generator=g, device=dev) < 0.8
    mask[:, 0] = True
    before = fa.decode_attention.launches
    out = fa.decode_attention(q, k, v, mask, n_kv=n_kv, layer=1, block=block)
    walk = fa.decode_attention_walk(q, k, v, mask, n_kv=n_kv, layer=1, block=block)
    torch.cuda.synchronize()
    assert fa.decode_attention.launches == before + 1
    assert torch.equal(out, walk)


def test_decode_wrappers_raise_instead_of_falling_back(dev):
    counts = [f.launches for f in (fa.decode_attention_q_chunk, fa.decode_attention)]
    kq = torch.zeros(1, 1, 256, 32, dtype=torch.int8, device=dev)
    ks = torch.zeros(1, 1, 2, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):                         # fp32 scales: no kernel
        fa.decode_attention_q_chunk(torch.zeros(1, 3, 32, device=dev), kq, ks.float(), kq,
                                    ks.float(), torch.zeros(1, dtype=torch.int32, device=dev),
                                    n_kv=2, head_dim=16)
    kc = torch.zeros(1, 1, 256, 32, device=dev)
    mask = torch.ones(1, 256, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):                         # q and cache dtypes differ
        fa.decode_attention(torch.zeros(1, 32, device=dev).bfloat16(), kc, kc, mask, n_kv=2)
    with pytest.raises(ValueError):                         # fp16: no kernel
        fa.decode_attention(torch.zeros(1, 32, device=dev).half(), kc.half(), kc.half(), mask,
                            n_kv=2)
    assert [f.launches for f in (fa.decode_attention_q_chunk, fa.decode_attention)] == counts


# ---------------------------------------------------------------------------
# K1b-K3b: the backward kernels
# ---------------------------------------------------------------------------

def _close_grads(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            _close_scaled(a, b, dtype)


def _autograd(fn, inputs, g):
    """The gradients of fn's output through its torch.autograd.Function."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,causal", [(37, 16, True), (130, 20, True), (70, 128, True),
                                        (65, 64, False)])
def test_k1b_kernel_matches_plain(dev, dtype, n, d, causal):
    g = torch.Generator(device=dev).manual_seed(n * d + 1)
    q, k, v, go = (torch.randn(2, 3, n, d, generator=g, device=dev).to(dtype) for _ in range(4))
    pos = torch.arange(n, device=dev)[None]
    # row 1: keys 0-4 and the last 11 invalid, so under the causal mask its
    # queries 0-4 see no key at all (fully masked rows: no gradient)
    kv = torch.stack([pos[0] < n, (pos[0] >= 5) & (pos[0] < n - 11)])
    out, lse = fa.flash_attention(q, k, v, causal, kv, return_lse=True)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, causal, kv, out, lse, go)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    _close_grads(got, fa.flash_attention_bwd_reference(q, k, v, causal, kv, out, lse, go), dtype)
    if causal:
        assert not got[0][1, :, :5].any()
    auto = _autograd(lambda a, b, c: fa.flash_attention(a, b, c, causal, kv), (q, k, v), go)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))   # one kernel, deterministic


def _k1b_inputs(dev, n, d, seed, dtype=torch.bfloat16):
    """q, k, v, g [2, 3, N, D]; key_valid: row 1 without keys 0-4 and the
    last 11 (under the causal mask its queries 0-4 see no key); out, lse
    from K1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, go = (torch.randn(2, 3, n, d, generator=g, device=dev).to(dtype) for _ in range(4))
    pos = torch.arange(n, device=dev)
    kv = torch.stack([pos < n, (pos >= 5) & (pos < n - 11)])
    out, lse = fa.flash_attention(q, k, v, True, kv, return_lse=True)
    return q, k, v, kv, out, lse, go


# K1b's bf16 route runs the pair layout of the tensor-core engine: N = 767
# (the training step's, 11 x 64 + 63), 70 and 37, at the LLM's D = 128,
# SAM's 80 and 64; fully masked rows get exactly zero dq
@pytest.mark.parametrize("n", [767, 70, 37])
@pytest.mark.parametrize("d", [128, 80, 64])
def test_k1b_bf16_tensor_core_route_matches_plain(dev, n, d):
    q, k, v, kv, out, lse, go = _k1b_inputs(dev, n, d, n * d + 7)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, True, kv, out, lse, go)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_reference(q, k, v, True, kv, out, lse, go)
    _close_grads(got, want, torch.bfloat16)
    assert not got[0][1, :, :5].any()


@pytest.mark.parametrize("n,d", [(767, 128), (70, 80)])
def test_k1b_is_deterministic(dev, n, d):
    """Two K1b calls on the same inputs give the same bits: every gradient
    element is summed by one owner in a fixed order (no atomics)."""
    q, k, v, kv, out, lse, go = _k1b_inputs(dev, n, d, n * d + 8)
    first = fa.flash_attention_bwd(q, k, v, True, kv, out, lse, go)
    second = fa.flash_attention_bwd(q, k, v, True, kv, out, lse, go)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _k1b_products(q, k, v, kv, out, lse, g, single):
    """dq, dk, dv from K1b's fp32 p and ds (s = scale (q . k), dp = g . v)
    with float64 products; single: p and ds rounded to bf16 alone first."""
    n, d = q.shape[2], q.shape[-1]
    scale = d ** -0.5
    pos = torch.arange(n, device=q.device)
    mask = kv[:, None, None, :] & (pos[None, :] <= pos[:, None])[None, None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()).float() * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g.double(), v.double()).float()
    ds = p * (dp - fa._delta(g, out)[..., None])
    if single:
        p, ds = p.to(q.dtype), ds.to(q.dtype)
    p, ds = p.double(), ds.double()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.double()) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q.double()) * scale,
            torch.einsum("bhqk,bhqd->bhkd", p, g.double()))


@pytest.mark.parametrize("n,d", [(200, 128), (70, 80)])
def test_k1b_split_products_beat_bf16_alone(dev, n, d):
    """K1b's bf16 dq, dk and dv against float64 products of its own p and
    ds, all rounded to bf16: the hi + lo split keeps about 16 bits of p and
    ds, so the kernel's mean error stays 8 times under that of rounding p
    and ds to bf16 alone (chip_smoke.py's SPLIT_GAIN), at a causal shape
    with padded keys."""
    q, k, v, kv, out, lse, go = _k1b_inputs(dev, n, d, n * d + 9)
    got = fa.flash_attention_bwd(q, k, v, True, kv, out, lse, go)
    args = (q, k, v, kv, out, lse, go)
    for a, e, si in zip(got, _k1b_products(*args, False), _k1b_products(*args, True)):
        e = e.to(torch.bfloat16).float()
        err_kernel = (a.float() - e).abs().mean()
        err_single = (si.to(torch.bfloat16).float() - e).abs().mean()
        assert err_kernel * 8 <= err_single, (float(err_kernel), float(err_single))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,d,h", [(2, 16, 2), (3, 20, 3), (14, 80, 2)])
def test_k2b_kernel_matches_plain(dev, dtype, ws, d, h):
    g = torch.Generator(device=dev).manual_seed(ws * d + 2)
    bw, t = 5, ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=g, device=dev).to(dtype)
    rel = torch.randn(bw, t, 2 * h * ws, generator=g, device=dev).to(dtype)
    go = torch.randn(bw, t, h * d, generator=g, device=dev).to(dtype)
    out, lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    before = fa.sam_window_attention_packed_bwd.launches
    got = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, out, lse, go)
    torch.cuda.synchronize()
    assert fa.sam_window_attention_packed_bwd.launches == before + 1
    want = fa.sam_window_attention_packed_bwd_reference(qkv, rel, h, d, ws, out, lse, go)
    _close_grads(got, want, dtype)
    auto = _autograd(lambda a, b: fa.sam_window_attention_packed(a, b, h, d, ws), (qkv, rel), go)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


def _k2b_inputs(dev, bw, h, ws, d, seed):
    """qkv, rel, the cotangent (bf16, packed layouts) and K2's out and lse."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=g, device=dev).to(torch.bfloat16)
    rel = torch.randn(bw, t, 2 * h * ws, generator=g, device=dev).to(torch.bfloat16)
    go = torch.randn(bw, t, h * d, generator=g, device=dev).to(torch.bfloat16)
    out, lse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    return qkv, rel, go, out, lse


# K2b's bf16 route runs the tensor-core engine: the ViT-H windows (T = 196,
# D = 80, key tiles that cut window rows) and ragged windows (T = 9, 25,
# 49; D = 16, 20 with 2-byte loads and a padded head dim; odd BW * H; ws =
# 17 takes the general rel-gradient path); deterministic (two calls, the
# same bits)
@pytest.mark.parametrize("bw,h,ws,d", [(50, 16, 14, 80), (5, 3, 3, 16), (3, 3, 5, 20),
                                       (5, 3, 7, 80), (3, 1, 7, 20), (3, 3, 14, 20),
                                       (2, 2, 17, 16)])
def test_k2b_bf16_tensor_core_route_matches_plain(dev, bw, h, ws, d):
    qkv, rel, go, out, lse = _k2b_inputs(dev, bw, h, ws, d, bw * ws + d)
    before = fa.sam_window_attention_packed_bwd.launches
    got = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, out, lse, go)
    again = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, out, lse, go)
    torch.cuda.synchronize()
    assert fa.sam_window_attention_packed_bwd.launches == before + 2
    want = fa.sam_window_attention_packed_bwd_reference(qkv, rel, h, d, ws, out, lse, go)
    _close_grads(got, want, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(50, 196, 16, 80), (3, 9, 2, 20), (2, 1, 1, 33)])
def test_window_delta_matches_plain(dev, dtype, shape):
    """K2b's and K10b's delta kernel against the plain _delta: fp32 sums of
    the same exact products in another order, each row within 1e-5 of the
    sum of its terms' magnitudes."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    go, out = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(2))
    got = fa._window_delta("delta", go, out)
    torch.cuda.synchronize()
    assert got.shape == shape[:-1] and got.dtype == torch.float32
    assert ((got - fa._delta(go, out)).abs() <= 1e-5 * fa._delta(go.abs(), out.abs())).all()


def _window_products(q, k, v, rel_h, rel_w, ws, out, lse, g, single):
    """dq, dk, dv from the window backward's fp32 p and ds (s = (q *
    scale)_bf16 . k + (rel_h + rel_w), dp = g . v from the bf16 operands)
    with float64 products; single: p and ds rounded to bf16 alone first."""
    d, key = q.shape[-1], torch.arange(q.shape[2], device=q.device)
    scale = d ** -0.5
    qs = (q * torch.tensor(scale, dtype=q.dtype)).double()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.double()).float()
    p = torch.exp(s + (rel_h.float()[..., key // ws] + rel_w.float()[..., key % ws])
                  - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g.double(), v.double()).float()
    ds = p * (dp - fa._delta(g, out)[..., None])
    if single:
        p, ds = p.to(q.dtype), ds.to(q.dtype)
    p, ds = p.double(), ds.double()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.double()) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q.double()) * scale,
            torch.einsum("bhqk,bhqd->bhkd", p, g.double()))


@pytest.mark.parametrize("ws,d", [(14, 80), (7, 20)])
def test_k2b_split_products_beat_bf16_alone(dev, ws, d):
    """K2b's bf16 dq, dk and dv against float64 products of its own p and
    ds, all rounded to bf16: the hi + lo split keeps about 16 bits of p and
    ds, so the kernel's mean error stays 8 times under that of rounding p
    and ds to bf16 alone (chip_smoke.py's SPLIT_GAIN)."""
    bw, h = 5, 3
    qkv, rel, go, out, lse = _k2b_inputs(dev, bw, h, ws, d, ws * d + 6)
    dqkv = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, out, lse, go)[0]
    got = [fa._win_heads(x, h, d) for x in dqkv.split(h * d, dim=-1)]
    args = (*fa._win_split_heads(qkv, rel, h, d, ws), ws, fa._win_heads(out, h, d),
            lse.transpose(1, 2), fa._win_heads(go, h, d))
    for a, e, si in zip(got, _window_products(*args, False), _window_products(*args, True)):
        e = e.to(torch.bfloat16).float()
        err_kernel = (a.float() - e).abs().mean()
        err_single = (si.to(torch.bfloat16).float() - e).abs().mean()
        assert err_kernel * 8 <= err_single, (float(err_kernel), float(err_single))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,d", K3_SHAPES)
def test_k3b_kernel_matches_plain(dev, dtype, gh, gw, d):
    g = torch.Generator(device=dev).manual_seed(gh * gw + d + 3)
    b, h, n = 2 if gh * gw <= 256 else 1, 2, gh * gw
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev).to(dtype)
    q, k, v = (x.reshape(b, n, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    rel_h = torch.randn(b, h, n, gh, generator=g, device=dev).to(dtype)
    rel_w = torch.randn(b, h, n, gw, generator=g, device=dev).to(dtype)
    go = torch.randn(b, h, n, d, generator=g, device=dev).to(dtype)
    out, lse = fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    before = fa.sam_flash_attention_bwd.launches
    got = fa.sam_flash_attention_bwd(q, k, v, rel_h, rel_w, (gh, gw), out, lse, go)
    torch.cuda.synchronize()
    assert fa.sam_flash_attention_bwd.launches == before + 1
    want = fa.sam_flash_attention_bwd_reference(q, k, v, rel_h, rel_w, (gh, gw), out, lse, go)
    _close_grads(got, want, dtype)
    auto = _autograd(lambda *x: fa.sam_flash_attention(*x, (gh, gw)), (q, k, v, rel_h, rel_w), go)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,d", [(12, 40, 64), (64, 64, 80)])
def test_k3b_is_deterministic(dev, dtype, gh, gw, d):
    """Two K3b calls on the same inputs give the same bits: every gradient
    element is summed by one owner in a fixed order (no atomics)."""
    g = torch.Generator(device=dev).manual_seed(gh * gw + d + 4)
    n = gh * gw
    q, k, v, go = (torch.randn(1, 2, n, d, generator=g, device=dev).to(dtype) for _ in range(4))
    rel_h = torch.randn(1, 2, n, gh, generator=g, device=dev).to(dtype)
    rel_w = torch.randn(1, 2, n, gw, generator=g, device=dev).to(dtype)
    out, lse = fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    first = fa.sam_flash_attention_bwd(q, k, v, rel_h, rel_w, (gh, gw), out, lse, go)
    second = fa.sam_flash_attention_bwd(q, k, v, rel_h, rel_w, (gh, gw), out, lse, go)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _k3b_products(q, k, v, rel_h, rel_w, gw, out, lse, g, single):
    """dq, dk, dv from K3b's fp32 p and ds (s and dp from the bf16
    operands) with float64 products; single: p and ds rounded to bf16
    alone first."""
    d, key = q.shape[-1], torch.arange(q.shape[2], device=q.device)
    scale = d ** -0.5
    qs = (q * torch.tensor(scale, dtype=q.dtype)).double()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.double()).float()
    p = torch.exp((s + rel_w.float()[..., key % gw]) + rel_h.float()[..., key // gw]
                  - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g.double(), v.double()).float()
    ds = p * (dp - fa._delta(g, out)[..., None])
    if single:
        p, ds = p.to(q.dtype), ds.to(q.dtype)
    p, ds = p.double(), ds.double()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.double()) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q.double()) * scale,
            torch.einsum("bhqk,bhqd->bhkd", p, g.double()))


@pytest.mark.parametrize("gh,gw,d", [(12, 40, 64), (64, 64, 80)])
def test_k3b_split_products_beat_bf16_alone(dev, gh, gw, d):
    """K3b's bf16 dq, dk and dv against float64 products of its own p and
    ds, all rounded to bf16: the hi + lo split keeps about 16 bits of p and
    ds, so the kernel's mean error stays 8 times under that of rounding p
    and ds to bf16 alone (chip_smoke.py's SPLIT_GAIN)."""
    g = torch.Generator(device=dev).manual_seed(gh * gw + d + 5)
    n = gh * gw
    q, k, v, go = (torch.randn(1, 2, n, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    rel_h = torch.randn(1, 2, n, gh, generator=g, device=dev).to(torch.bfloat16)
    rel_w = torch.randn(1, 2, n, gw, generator=g, device=dev).to(torch.bfloat16)
    out, lse = fa.sam_flash_attention(q, k, v, rel_h, rel_w, (gh, gw), return_lse=True)
    got = fa.sam_flash_attention_bwd(q, k, v, rel_h, rel_w, (gh, gw), out, lse, go)
    args = (q, k, v, rel_h, rel_w, gw, out, lse, go)
    for a, e, si in zip(got, _k3b_products(*args, False), _k3b_products(*args, True)):
        e = e.to(torch.bfloat16).float()
        err_kernel = (a.float() - e).abs().mean()
        err_single = (si.to(torch.bfloat16).float() - e).abs().mean()
        assert err_kernel * 8 <= err_single, (float(err_kernel), float(err_single))


def test_backward_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros(1, 1, 4, 16, device=dev)
    lse = torch.zeros(1, 1, 4, device=dev)
    before = [f.launches for f in fa.KERNELS]
    with pytest.raises(ValueError):                         # fp16: no kernel
        fa.flash_attention_bwd(q.half(), q.half(), q.half(), True, None, q.half(), lse, q.half())
    with pytest.raises(ValueError):                         # g of another shape
        fa.flash_attention_bwd(q, q, q, True, None, q, lse, q[:, :, :3])
    with pytest.raises(ValueError):                         # T != ws * ws
        qkv = torch.zeros(2, 5, 3 * 16, device=dev)
        fa.sam_window_attention_packed_bwd(qkv, torch.zeros(2, 5, 4, device=dev), 1, 16, 2,
                                           qkv[..., :16], torch.zeros(2, 5, 1, device=dev),
                                           qkv[..., :16])
    assert [f.launches for f in fa.KERNELS] == before



# ---------------------------------------------------------------------------
# K10 / K10b: windowed attention over the split-head layout
# ---------------------------------------------------------------------------

def _k10_inputs(dev, dtype, rel_dtype, bw, h, ws, d, seed):
    """q, k, v as strided head views of one projection (as the encoder's
    split_heads gives them), rel_h, rel_w in rel_dtype, the cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = ws * ws
    qkv = torch.randn(bw, t, 3 * h * d, generator=g, device=dev).to(dtype)
    q, k, v = (x.reshape(bw, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    rel_h, rel_w = (torch.randn(bw, h, t, ws, generator=g, device=dev).to(rel_dtype)
                    for _ in range(2))
    go = torch.randn(bw, h, t, d, generator=g, device=dev).to(dtype)
    return q, k, v, rel_h, rel_w, go


K10_CASES = [(torch.float32, torch.float32, 3, 2, 3, 16), (torch.float32, torch.float32, 5, 3, 5, 80),
             (torch.bfloat16, torch.bfloat16, 4, 2, 14, 80),
             (torch.bfloat16, torch.float32, 3, 3, 5, 20)]


@pytest.mark.parametrize("dtype,rel_dtype,bw,h,ws,d", K10_CASES)
def test_k10_kernel_matches_plain_and_k2(dev, dtype, rel_dtype, bw, h, ws, d):
    q, k, v, rel_h, rel_w, _ = _k10_inputs(dev, dtype, rel_dtype, bw, h, ws, d, ws * d + 4)
    before = fa.sam_window_attention.launches
    out, lse = fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    torch.cuda.synchronize()
    assert fa.sam_window_attention.launches == before + 1
    ref, ref_lse = fa.sam_window_attention_reference(q, k, v, rel_h, rel_w, ws)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    if rel_dtype == dtype:      # K2 on the same values, repacked: one engine, bit for bit
        merge = lambda x: x.transpose(1, 2).reshape(bw, ws * ws, -1)
        packed, packed_lse = fa.sam_window_attention_packed(
            torch.cat([merge(x) for x in (q, k, v)], -1), torch.cat([merge(rel_h), merge(rel_w)], -1),
            h, d, ws, return_lse=True)
        assert torch.equal(merge(out), packed) and torch.equal(lse, packed_lse.transpose(1, 2))


@pytest.mark.parametrize("dtype,rel_dtype,bw,h,ws,d", K10_CASES)
def test_k10b_kernel_matches_plain(dev, dtype, rel_dtype, bw, h, ws, d):
    q, k, v, rel_h, rel_w, go = _k10_inputs(dev, dtype, rel_dtype, bw, h, ws, d, ws * d + 5)
    out, lse = fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    before = fa.sam_window_attention_bwd.launches
    got = fa.sam_window_attention_bwd(q, k, v, rel_h, rel_w, ws, out, lse, go)
    torch.cuda.synchronize()
    assert fa.sam_window_attention_bwd.launches == before + 1
    want = fa.sam_window_attention_bwd_reference(q, k, v, rel_h, rel_w, ws, out, lse, go)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        if a.dtype == torch.float32 and dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            _close_scaled(a, b, torch.bfloat16)
    auto = _autograd(lambda *x: fa.sam_window_attention(*x, ws), (q, k, v, rel_h, rel_w), go)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


@pytest.mark.parametrize("bw,h,ws,d", [(4, 2, 14, 80), (3, 1, 7, 20), (5, 3, 3, 16)])
def test_k10b_equals_k2b_on_repacked_values(dev, bw, h, ws, d):
    """bf16: K10b and K2b run one engine with the same expressions in the
    same order, so on the same values repacked their gradients are equal
    bit for bit."""
    q, k, v, rel_h, rel_w, go = _k10_inputs(dev, torch.bfloat16, torch.bfloat16, bw, h, ws, d,
                                            ws * d + 7)
    out, lse = fa.sam_window_attention(q, k, v, rel_h, rel_w, ws, return_lse=True)
    grads = fa.sam_window_attention_bwd(q, k, v, rel_h, rel_w, ws, out, lse, go)
    merge = lambda x: x.transpose(1, 2).reshape(bw, ws * ws, -1)
    qkv = torch.cat([merge(x) for x in (q, k, v)], -1)
    rel = torch.cat([merge(rel_h), merge(rel_w)], -1)
    pout, plse = fa.sam_window_attention_packed(qkv, rel, h, d, ws, return_lse=True)
    dqkv, drel = fa.sam_window_attention_packed_bwd(qkv, rel, h, d, ws, pout, plse, merge(go))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([merge(x) for x in grads[:3]], -1), dqkv)
    assert torch.equal(torch.cat([merge(x) for x in grads[3:]], -1), drel)


def test_k10_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros(1, 1, 9, 16, device=dev)
    rel = torch.zeros(1, 1, 9, 3, device=dev)
    lse = torch.zeros(1, 1, 9, device=dev)
    before = [f.launches for f in fa.KERNELS]
    with pytest.raises(ValueError):                         # fp16: no kernel
        fa.sam_window_attention(q.half(), q.half(), q.half(), rel.half(), rel.half(), 3)
    with pytest.raises(ValueError):                         # T != ws * ws
        fa.sam_window_attention(q, q, q, rel, rel, 2)
    with pytest.raises(ValueError):                         # rel on the CPU
        fa.sam_window_attention(q, q, q, rel.cpu(), rel.cpu(), 3)
    with pytest.raises(ValueError):                         # rel in bf16 with fp32 q
        fa.sam_window_attention_bwd(q, q, q, rel.bfloat16(), rel.bfloat16(), 3, q, lse, q)
    assert [f.launches for f in fa.KERNELS] == before

def test_quantizers_give_the_cpus_codes_and_scales(dev):
    """The quantizers divide by a 0-d tensor (core/nn.div_exact): a Python
    divisor is a reciprocal multiplication on CUDA, whose scales differ from
    the CPU's in the last bit."""
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn(512, 384, generator=g, device=dev) * 0.02
    for fn in (quant.quantize_weight, int4.quantize_weight4, int4.pack_down4):
        card, cpu = fn(w), fn(w.cpu())
        assert all(torch.equal(card[k].cpu(), cpu[k]) for k in cpu), fn.__name__
    x = torch.randn(2, 9, 4, 16, generator=g, device=dev)
    for fn in (llm._quant_rows, llm._quant_pack4_flat):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(fn(x), fn(x.cpu()))), fn.__name__


@pytest.mark.parametrize("b,h,d,l,block,valid,pack4,i_dim,act,x_dtype,pn_dtype", [
    (2, 2, 8, 16, 8, 7, True, 96, "silu", torch.bfloat16, torch.float32),
    (3, 4, 20, 96, 32, None, False, 160, "gelu", torch.float32, torch.float32),
    (2, 5, 24, 64, 64, 40, True, 384, "silu", torch.float32, torch.bfloat16),
    (2, 32, 128, 512, 256, 480, True, 11008, "silu", torch.bfloat16, torch.bfloat16)])
def test_k12_kernel_matches_plain(dev, b, h, d, l, block, valid, pack4, i_dim, act, x_dtype,
                                  pn_dtype):
    g = torch.Generator(device=dev).manual_seed(h * d + i_dim)
    hd = h * d
    kq, ks, vq, vs = _flat_cache(dev, g, b, l, h, d, pack4)
    q = torch.randn(b, hd, generator=g, device=dev)
    lens = torch.tensor([[valid or l]] + [[l // 2 + 1]] * (b - 1), device=dev)
    mask = torch.arange(l, device=dev)[None] < lens
    x = (torch.randn(b, hd, generator=g, device=dev) * 0.5).to(x_dtype)
    o = quant.convert_proj({"w": torch.randn(hd, hd, generator=g, device=dev) * 0.05}, True)
    pn = (1.0 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(pn_dtype)
    mlp = _mlp(dev, g, hd, i_dim, act, "int4")
    q8, qs = fa.banded_q8(q, n_kv=h, head_dim=d)
    kw = dict(n_kv=h, head_dim=d, pack4=pack4, layer=1, act=act, norm_eps=1e-6, block=block,
              valid_len=valid)
    before = fused_layer.fused_layer_tail.launches
    y = fused_layer.fused_layer_tail(x, q8, qs, kq, ks, vq, vs, mask, o, pn, mlp, **kw)
    torch.cuda.synchronize()
    assert fused_layer.fused_layer_tail.launches == before + 1
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, hd)
    _close_scaled(y, fused_layer.fused_layer_tail_reference(x, q8, qs, kq, ks, vq, vs, mask, o,
                                                            pn, mlp, **kw), torch.bfloat16)
    # the wrapper's result is row 2 of its scratch [attention rows, x2, y, partials]
    att = fa.decode_attention_q_reference(q, kq, ks, vq, vs, mask, n_kv=h, head_dim=d,
                                          pack4=pack4, layer=1, block=block, valid_len=valid)
    _close_scaled(y._base[0], att, torch.float32)


# K12_SHAPES: (b, h, d, l, block, valid, pack4, i_dim, act, x_dtype, pn_dtype)
K12_SHAPES = [
    (2, 2, 8, 16, 8, 7, True, 96, "gelu", torch.float32, torch.float32),
    (3, 5, 24, 64, 64, 40, True, 384, "silu", torch.float32, torch.bfloat16),
    (2, 8, 128, 256, 256, 200, False, 2816, "gelu", torch.bfloat16, torch.bfloat16),
    (2, 32, 128, 512, 256, 480, True, 11008, "silu", torch.bfloat16, torch.bfloat16),
    (4, 32, 128, 512, 256, 480, True, 11008, "silu", torch.bfloat16, torch.bfloat16),
    (32, 32, 128, 512, 256, 480, True, 11008, "silu", torch.bfloat16, torch.bfloat16),
    (16, 40, 128, 512, 256, 480, True, 13824, "silu", torch.bfloat16, torch.bfloat16)]


def _k12_run(dev, b, h, d, l, block, valid, pack4, i_dim, act, x_dtype, pn_dtype):
    """K12 on random inputs: (y, q, cache, mask, mlp, kw)."""
    g = torch.Generator(device=dev).manual_seed(b * h * d + i_dim)
    hd = h * d
    kq, ks, vq, vs = _flat_cache(dev, g, b, l, h, d, pack4)
    q = torch.randn(b, hd, generator=g, device=dev)
    mask = torch.arange(l, device=dev)[None] < torch.tensor([[valid]] * b, device=dev)
    x = (torch.randn(b, hd, generator=g, device=dev) * 0.5).to(x_dtype)
    o = quant.convert_proj({"w": torch.randn(hd, hd, generator=g, device=dev) * 0.05}, True)
    pn = (1.0 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(pn_dtype)
    mlp = _mlp(dev, g, hd, i_dim, act, "int4")
    q8, qs = fa.banded_q8(q, n_kv=h, head_dim=d)
    kw = dict(n_kv=h, head_dim=d, pack4=pack4, layer=1, act=act, norm_eps=1e-6, block=block,
              valid_len=valid)
    y = fused_layer.fused_layer_tail(x, q8, qs, kq, ks, vq, vs, mask, o, pn, mlp, **kw)
    torch.cuda.synchronize()
    return y, q, (kq, ks, vq, vs), mask, mlp, kw


@pytest.mark.parametrize("b,h,d,l,block,valid,pack4,i_dim,act,x_dtype,pn_dtype", K12_SHAPES)
def test_k12_attention_rows_and_oproj_codes(dev, b, h, d, l, block, valid, pack4, i_dim, act,
                                            x_dtype, pn_dtype):
    """K12's attention rows (scratch row 0) within chip_smoke's
    QUANT_FP32_REL (1e-3) of K4's plain version on the same q, relative to
    their largest magnitude; their o-proj codes (the TPU kernel's quantizer)
    within one of the plain rows' and at most chip_smoke's K12_CODE_FLIPS
    (1e-2) of them moved."""
    y, q, cache, mask, _, kw = _k12_run(dev, b, h, d, l, block, valid, pack4, i_dim, act,
                                        x_dtype, pn_dtype)
    att = fa.decode_attention_q_reference(q, *cache, mask, n_kv=h, head_dim=d, pack4=pack4,
                                          layer=1, block=block, valid_len=valid)
    got = y._base[fused_layer.SCRATCH_ROWS["attention"]]
    err = (got - att).abs().max() / max(1.0, float(att.abs().max()))
    assert err <= 1e-3, err

    def codes(a):
        sr = a.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
        return torch.clamp(torch.round(a / sr), -127, 127)
    moved = (codes(got) - codes(att)).abs()
    assert moved.max() <= 1 and (moved > 0).float().mean() <= 1e-2


@pytest.mark.parametrize("b,h,d,l,block,valid,pack4,i_dim,act,x_dtype,pn_dtype", K12_SHAPES)
def test_k12_mlp_partials_equal_k6_on_its_normed_rows(dev, b, h, d, l, block, valid, pack4,
                                                      i_dim, act, x_dtype, pn_dtype):
    """K12's MLP phases run K6's two passes: its tiles' partials equal K6's
    (its C entry on the scratch's hn row) bit for bit, and y is x2 plus
    them in tile order."""
    y, _, _, _, mlp, _ = _k12_run(dev, b, h, d, l, block, valid, pack4, i_dim, act, x_dtype,
                                  pn_dtype)
    rows = fused_layer.fused_layer_tail_plan(b, h, d, l, i_dim, pack4, block)["scratch"]
    parts = y._base[rows["parts"]:rows["rows"]]
    assert torch.equal(parts, int4.fused_mlp_int4_parts(mlp, y._base[rows["hn"]], act))
    want = y._base[rows["x2"]].clone()
    for t in range(parts.shape[0]):
        want = want + parts[t]
    assert torch.equal(y, want)


@pytest.mark.parametrize("b,h,d,l,block,valid,pack4,i_dim,act,x_dtype,pn_dtype", K12_SHAPES)
def test_k12_plan_mirror_matches_the_launch(dev, b, h, d, l, block, valid, pack4, i_dim, act,
                                            x_dtype, pn_dtype):
    """fused_layer_tail_plan gives the launch the CUDA runtime plans
    (fused_layer_tail_info): blocks, blocks an SM, shared memory, rows per
    pass and whether hn is held in shared memory; two blocks an SM at D =
    128, whatever the rows."""
    info = fused_layer.fused_layer_tail_info(b, h, d, l, i_dim, pack4, x_dtype, pn_dtype, dev,
                                             block)
    plan = fused_layer.fused_layer_tail_plan(b, h, d, l, i_dim, pack4, block, info["sms"])
    for key in ("blocks", "blocks_per_sm", "smem", "rows_per_pass", "hn_held"):
        assert info[key] == plan[key], (key, info[key], plan[key])
    if d == 128:
        assert info["blocks_per_sm"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(37, 96), (37, 100), (130, 260), (8192, 1280), (8192, 5120),
                                 (4, 40000)])
def test_k13a_plan_mirror_matches_the_launch(dev, dtype, m, k):
    """quantize_tokens_plan gives the launch csrc/int8_gemm.cu plans
    (quantize_tokens_info), key for key."""
    assert int8_gemm.quantize_tokens_info(m, k, dtype) == int8_gemm.quantize_tokens_plan(m, k,
                                                                                          dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 1280), (8192, 5120), (37, 100), (130, 260)])
def test_k13a_one_pass_matches_plain_bit_for_bit(dev, dtype, shape):
    """K13a at ViT-H fc1's and fc2's inputs and at K % 16 != 0 (4-value
    segments): codes and scales the plain version's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(sum(shape) + 1)
    x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
    x[1, 7:] = 0.0                                           # a row's tail of zeros
    xq, sx = int8_gemm.quantize_tokens(x)
    torch.cuda.synchronize()
    want_q, want_s = int8_gemm.quantize_tokens_reference(x)
    assert torch.equal(xq, want_q) and torch.equal(sx, want_s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (37, 256), (3, 43, 384), (9800, 1280)])
def test_k13a_kernel_matches_plain_bit_for_bit(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
    x[..., 0, :5] = 0.0                                      # a row's head of zeros
    before = int8_gemm.quantize_tokens.launches
    xq, sx = int8_gemm.quantize_tokens(x)
    torch.cuda.synchronize()
    assert int8_gemm.quantize_tokens.launches == before + 1
    want_q, want_s = int8_gemm.quantize_tokens_reference(x)
    assert xq.shape == want_q.shape and sx.shape == want_s.shape
    assert torch.equal(xq, want_q) and torch.equal(sx, want_s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,bias,act", [
    (1, 64, 128, False, None), (37, 256, 384, True, "gelu_exact"), (130, 96, 20, True, "gelu_tanh"),
    (9800, 1280, 3840, True, None), (8192, 1280, 5120, True, "gelu_exact"),
    (8192, 5120, 1280, True, None)])
def test_k13b_kernel_matches_plain(dev, dtype, m, k, n, bias, act):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = quant.convert_proj({"w": torch.randn(k, n, generator=g, device=dev) * 0.05}, True)
    b = torch.randn(n, generator=g, device=dev) * 0.1 if bias else None
    before = int8_gemm.w8a8_gemm.launches
    y = int8_gemm.w8a8_gemm(x, w["w_q"], w["w_scale"], b, act=act)
    torch.cuda.synchronize()
    assert int8_gemm.w8a8_gemm.launches == before + 1
    want = int8_gemm.w8a8_gemm_reference(x, w["w_q"], w["w_scale"], b, act=act)
    assert y.dtype == dtype and y.shape == want.shape
    scale = float(want.float().abs().max())
    rtol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,bias,act", [
    (1, 64, 128, False, None), (37, 256, 384, True, "gelu_exact"), (130, 96, 20, True, "gelu_tanh"),
    (300, 400, 260, True, None), (8192, 1280, 5120, True, "gelu_exact")])
def test_k13b_tensor_core_route_equals_the_first_design(dev, dtype, m, k, n, bias, act):
    g = torch.Generator(device=dev).manual_seed(m + k + n + 1)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = quant.convert_proj({"w": torch.randn(k, n, generator=g, device=dev) * 0.05}, True)
    b = torch.randn(n, generator=g, device=dev) * 0.1 if bias else None
    assert int8_gemm.w8a8_gemm_plan(m, k, n)["route"] == "wgmma"
    y = int8_gemm.w8a8_gemm(x, w["w_q"], w["w_scale"], b, act=act)
    first = int8_gemm.w8a8_gemm_mma_sync(x, w["w_q"], w["w_scale"], b, act=act)
    torch.cuda.synchronize()
    assert torch.equal(y, first)


def test_k12_k13_wrappers_raise_instead_of_falling_back(dev):
    before = [f.launches for f in int8_gemm.KERNELS + fused_layer.KERNELS]
    with pytest.raises(ValueError):                         # K % 4 != 0
        int8_gemm.quantize_tokens(torch.zeros(3, 6, device=dev))
    with pytest.raises(ValueError):                         # fp16: no kernel
        int8_gemm.w8a8_gemm(torch.zeros(3, 8, device=dev).half(),
                            torch.zeros(8, 4, dtype=torch.int8, device=dev),
                            torch.ones(4, device=dev))
    kq, ks, vq, vs = _flat_cache(dev, torch.Generator(device=dev).manual_seed(0), 2, 16, 1, 8,
                                 True)
    q8 = torch.zeros(2, 1, 2, 8, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="MHA"):            # GQA: no kernel
        fused_layer.fused_layer_tail(
            torch.zeros(2, 16, device=dev), q8, torch.ones(2, 1, 2, device=dev), kq, ks, vq, vs,
            torch.ones(2, 16, dtype=torch.bool, device=dev), {}, torch.ones(16, device=dev), {},
            n_kv=1, head_dim=8, pack4=True, layer=0, act="silu", norm_eps=1e-6)
    assert [f.launches for f in int8_gemm.KERNELS + fused_layer.KERNELS] == before


# ---------------------------------------------------------------------------
# the fp16 routes of K1, K4, K5, K6 and the decode blocks 128, 256, 512
# ---------------------------------------------------------------------------

def _close_fp16(got, want, bf16_inside):
    """fp16 against the plain version, relative to the output's largest
    magnitude (at least 1): one fp16 step (4e-3 max, 4e-4 mean) where the
    kernel rounds once at its output (K1, K5); the bf16 bounds where it
    rounds to bf16 inside (K4, K6)."""
    assert got.dtype == torch.float16 and torch.isfinite(got.float()).all()
    scale = max(1.0, float(want.float().abs().max()))
    err = (got.float() - want.float()).abs() / scale
    lim = (2e-2, 2e-3) if bf16_inside else (4e-3, 4e-4)
    assert err.max() <= lim[0] and err.mean() <= lim[1], (err.max(), err.mean())


@pytest.mark.parametrize("n,d,causal", [(37, 16, True), (130, 20, True), (447, 128, True),
                                        (65, 64, False)])
def test_k1_fp16_route_matches_plain(dev, n, d, causal):
    g = torch.Generator(device=dev).manual_seed(n * d + 1)
    q, k, v = (torch.randn(2, 3, n, d, generator=g, device=dev).half() for _ in range(3))
    kv = torch.arange(n, device=dev)[None] < torch.tensor([[n], [n - 11]], device=dev)
    out, lse = fa.flash_attention(q, k, v, causal, kv, return_lse=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal, kv)
    _close_fp16(out, ref, False)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("h,n_kv,d,l,pack4", [(4, 2, 16, 48, False), (6, 3, 8, 24, True),
                                               (32, 32, 128, 512, True)])
@pytest.mark.parametrize("qdot8,pv8", [(True, False), (False, False), (True, True)])
def test_k4_fp16_route_matches_plain(dev, h, n_kv, d, l, pack4, qdot8, pv8):
    g = torch.Generator(device=dev).manual_seed(h * d + l + 2)
    kq, ks, vq, vs = _flat_cache(dev, g, 2, l, n_kv, d, pack4)
    q = torch.randn(2, h * d, generator=g, device=dev).half()
    mask = torch.arange(l, device=dev)[None] < torch.tensor([[l * 3 // 4], [l // 2]], device=dev)
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=1, block=min(l, 256),
              valid_len=l * 3 // 4, qdot_int8=qdot8, pv_int8=pv8)
    out = fa.decode_attention_q(q, kq, ks, vq, vs, mask, **kw)
    _close_fp16(out, fa.decode_attention_q_reference(q, kq, ks, vq, vs, mask, **kw), True)
    assert torch.equal(out, fa.decode_attention_q_walk(q, kq, ks, vq, vs, mask, **kw))


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (2, 4096, 12288), (4, 4096, 32128)])
def test_k5_fp16_route_matches_plain(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n + 3)
    w = int4.quantize_weight4(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(m, k, generator=g, device=dev).half()
    out = int4.int4_matmul_pallas(x, w["w_p4"], w["w_scale"])
    _close_fp16(out, int4.int4_matmul_pallas_reference(x, w["w_p4"], w["w_scale"]), False)


@pytest.mark.parametrize("m,h,i_dim,act", [(1, 64, 96, "silu"), (2, 4096, 11008, "silu"),
                                           (3, 160, 200, "gelu"), (2, 4096, 16384, "gelu")])
def test_k6_fp16_route_matches_plain(dev, m, h, i_dim, act):
    g = torch.Generator(device=dev).manual_seed(m + h + i_dim + 4)
    p = _mlp(dev, g, h, i_dim, act, "int4")
    x = torch.randn(m, 1, h, generator=g, device=dev).half()
    _close_fp16(int4.fused_mlp_int4(p, x, act), int4.fused_mlp_int4_reference(p, x, act), True)


@pytest.mark.parametrize("block", [128, 256, 512])
def test_decode_kernels_at_each_block(dev, block):
    """K4 (against its plain version and its walk), K8, K11 (against its
    walk) and K12 at the 7B step's shapes with blocks of 128, 256 and 512
    keys over a 512-slot cache."""
    g = torch.Generator(device=dev).manual_seed(block)
    kq, ks, vq, vs = _flat_cache(dev, g, 2, 512, 32, 128, True)
    q = torch.randn(2, 4096, generator=g, device=dev).bfloat16()
    mask = torch.arange(512, device=dev)[None].expand(2, 512) < 480
    kw = dict(n_kv=32, head_dim=128, pack4=True, layer=1, block=block, valid_len=480)
    out = fa.decode_attention_q(q, kq, ks, vq, vs, mask, **kw)
    _close_scaled(out, fa.decode_attention_q_reference(q, kq, ks, vq, vs, mask, **kw),
                  torch.bfloat16)
    assert torch.equal(out, fa.decode_attention_q_walk(q, kq, ks, vq, vs, mask, **kw))
    qc = torch.randn(2, 9, 4096, generator=g, device=dev).bfloat16()
    cl = torch.tensor([440, 375], device=dev)
    kc = dict(n_kv=32, head_dim=128, pack4=True, layer=1, block=block)
    _close_scaled(fa.decode_attention_q_chunk(qc, kq, ks, vq, vs, cl, **kc),
                  fa.decode_attention_q_chunk_reference(qc, kq, ks, vq, vs, cl, **kc),
                  torch.bfloat16)
    kf = torch.randn(2, 2, 512, 4096, generator=g, device=dev).bfloat16()
    vf = torch.randn(2, 2, 512, 4096, generator=g, device=dev).bfloat16()
    assert torch.equal(fa.decode_attention(q, kf, vf, mask, n_kv=32, layer=1, block=block),
                       fa.decode_attention_walk(q, kf, vf, mask, n_kv=32, layer=1, block=block))

