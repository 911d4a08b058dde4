"""The CUDA kernels K1-K8, K11, K12, K13a/b and the backward kernels K1b-K3b
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
bf16 bounds above in bf16. K8's token t and K4 at the same position run one
engine over the same cache: equal bit for bit. K11 (fp32 online softmax,
p rounded to the cache's type) takes the K1-K3 bounds. The backward kernels
K1b-K3b sum over up to N terms per gradient in another order than the
plain backward: fp32 atol = rtol = 1e-4; bf16 outputs relative to their
largest magnitude (at least 1), 2e-2 max and 2e-3 mean, one bf16 rounding
step of the gradient. K12 rounds x2, the normed row and the MLP's
intermediate to bf16 inside, in fp32 models too: its output takes the bf16
bounds relative to its largest magnitude, whatever x's dtype, and its
attention rows K4's fp32 bound. K13a's codes and scales are the plain
version's bit for bit (same fp32 division, same rounding to x's dtype, same
half-to-even round); K13b's int32 sums are exact and its epilogue is the
plain version's operation for operation, so its outputs agree to erff /
tanhf last places: rtol 1e-6 in fp32, one bf16 step (2^-8) in bf16.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,d", [(4, 4, 16), (5, 7, 20), (16, 16, 80)])
def test_k3_kernel_matches_plain(dev, dtype, gh, gw, d):
    g = torch.Generator(device=dev).manual_seed(gh * gw + d)
    b, h, n = 2, 2, gh * gw
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
    with pytest.raises(ValueError):                         # fp16: no kernel
        fa.flash_attention(q.half(), q.half(), q.half(), True, None)
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
@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (2, 4096, 12288), (5, 96, 384), (2, 4096, 32128)])
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
                                           (2, 4096, 11008, "silu"), (2, 2048, 5504, "silu")])
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


@pytest.mark.parametrize("m,k,n", [(2, 4096, 4096), (2, 2048, 6144), (9800, 1280, 3840),
                                   (3, 20, 12)])
def test_int8_product_on_the_card_is_exact(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    assert torch.equal(int8_matmul(a, b).cpu(), a.cpu().int() @ b.cpu().int())


def test_quantized_wrappers_raise_instead_of_falling_back(dev):
    counts = [f.launches for f in (fa.decode_attention_q, *int4.KERNELS)]
    w = int4.quantize_weight4(torch.randn(64, 128, device=dev))
    with pytest.raises(ValueError):                         # fp16: no kernel
        int4.int4_matmul_pallas(torch.zeros(2, 64, device=dev).half(), w["w_p4"], w["w_scale"])
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
    (32, 32, 128, 512, 256, True, 9, [440, 375]), (16, 16, 128, 512, 256, False, 9, [440, 375])]


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
def test_k8_token_equals_k4_at_its_position(dev, dtype, h, n_kv, d, l, block, pack4, tc, cl):
    g = torch.Generator(device=dev).manual_seed(h * d + l + tc + 1)
    q, kq, ks, vq, vs, cache_len = _chunk_inputs(dev, g, dtype, 2, tc, h, n_kv, d, l, pack4, cl)
    kw = dict(n_kv=n_kv, head_dim=d, pack4=pack4, layer=0, block=block)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh,gw,d", [(4, 4, 16), (5, 7, 20), (16, 16, 80)])
def test_k3b_kernel_matches_plain(dev, dtype, gh, gw, d):
    g = torch.Generator(device=dev).manual_seed(gh * gw + d + 3)
    b, h, n = 2, 2, gh * gw
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
