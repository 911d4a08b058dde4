"""The CUDA kernels K1-K3 against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/ on first use) and
skip elsewhere. They import nothing of JAX, so they run on a machine without
it; tests/conftest.py imports jax, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py

Tolerances: fp32 atol = rtol = 1e-4 with TF32 off (same arithmetic, another
summation order and the kernel's online softmax); bf16: the kernel and the
plain version round at the same points, so outputs agree to about one bf16
rounding step of the output (atol 2e-2, mean-abs 2e-3).
"""
import pytest
import torch

from walkgpt_tpu_torch.ops import flash_attention as fa

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
