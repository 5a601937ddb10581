"""K1 on the card against its plain version.

This file needs no jax, so that it also runs on a machine with a CUDA card
and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_card.py

Without a card every test skips (a CUDA kernel has no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,kw,tol", [
    ((2, 128, 128, 4, 2, 64), "float32", dict(causal=True), 2e-5),
    ((1, 257, 129, 2, 2, 256), "float32", dict(causal=False), 2e-5),
    ((2, 300, 300, 8, 2, 96), "float32", dict(causal=True, window=37), 2e-5),
    ((2, 77, 200, 4, 2, 16), "float32", dict(causal=False, kv_valid=150), 2e-5),
    ((4, 1024, 1024, 16, 8, 128), "bfloat16", dict(causal=True), 3e-2),
])
def test_k1_kernel_matches_plain_on_card(shape, dtype, kw, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Skv, H, K, hd = shape
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(getattr(torch, dtype))
               for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd)))
    before = fa.flash_attention_hmajor.launches
    out = fa.flash_attention_hmajor(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_hmajor.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = fa.flash_attention_hmajor_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k1_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ with no CPU mode")
    q = torch.zeros(1, 2, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_hmajor(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    big = torch.zeros(1, 1, 8, 512, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_hmajor(big, big, big)
