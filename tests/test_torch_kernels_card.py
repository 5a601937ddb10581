"""K1 and K2 on the card against their plain versions.

Every f32 case has a bf16 twin: bf16 runs a tensor-core variant wherever
``k1_variant`` / ``k2_variant`` choose it (K1: "wg" at hd 64 and 128, "tc"
at the other multiples of 16; hd 72 stays on the CUDA-core "fma" kernel;
K2: "wg" at P and N of 64 and 128, "tc" at the other bf16 shapes), and each
call is counted under its variant.  Where K1 takes "wg", its "tc" kernel is
held on the same inputs too; where K2 takes "wg", it is held again at
several segment counts and twice for the same bits.

This file needs no jax, so that it also runs on a machine with a CUDA card
and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_card.py

Without a card every test skips (a CUDA kernel has no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from repro_torch.kernels.ref import ssd_ref  # noqa: E402


K1_CASES = [   # (B, Sq, Skv, H, K, hd), kwargs: each runs in f32 (2e-5) and bf16 (3e-2)
    ((2, 128, 128, 4, 2, 64), dict(causal=True)),
    ((1, 257, 129, 2, 2, 256), dict(causal=False)),
    ((1, 128, 128, 4, 2, 64), dict(causal=True, window=8)),
    ((1, 128, 128, 4, 2, 64), dict(causal=True, window=64)),
    ((1, 128, 128, 4, 2, 64), dict(causal=True, window=200)),
    ((2, 300, 300, 8, 2, 96), dict(causal=True, window=37)),
    ((2, 77, 200, 4, 2, 16), dict(causal=False, kv_valid=150)),
    ((2, 100, 100, 4, 2, 72), dict(causal=True)),
]
K1_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,kw,tol", [
    (shape, dtype, kw, K1_TOL[dtype]) for shape, kw in K1_CASES for dtype in K1_TOL
] + [
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
    variant = fa.k1_variant(q.dtype, hd)
    want = ("fma" if dtype == "float32" or hd == 72 else "wg" if hd in (64, 128) else "tc")
    assert variant == want
    before = fa.flash_attention_hmajor.launches
    by_variant = fa.flash_attention_hmajor.launches_by_variant[variant]
    out = fa.flash_attention_hmajor(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_hmajor.launches == before + 1
    assert fa.flash_attention_hmajor.launches_by_variant[variant] == by_variant + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = fa.flash_attention_hmajor_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if variant == "wg":
        full = dict(dict(causal=True, window=0, kv_valid=None, softmax_scale=None), **kw)
        tc = fa._launch(q, k, v, "tc", **full)
        torch.cuda.synchronize()
        torch.testing.assert_close(tc.float(), ref.float(), atol=tol, rtol=tol)


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


K2_CASES = [   # (B, S, H, G, P, N), chunk, h0: each in f32 (1e-4) and bf16 x/B/C (5e-2)
    ((1, 64, 4, 1, 32, 16), 16, False),
    ((2, 37, 4, 2, 16, 32), 16, False),
    ((1, 128, 2, 1, 64, 128), 32, False),
    ((1, 96, 8, 4, 16, 16), 48, False),
    ((2, 100, 4, 2, 32, 64), 32, True),
    ((1, 200, 2, 1, 128, 64), 64, True),       # P = 128: two consumer warpgroups ("wg")
]
K2_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,dtype,dt_dtype,with_h0,tol", [
    (shape, chunk, dtype, "float32", h0, K2_TOL[dtype])
    for shape, chunk, h0 in K2_CASES for dtype in K2_TOL
] + [
    ((1, 64, 2, 1, 32, 16), 16, "bfloat16", "bfloat16", False, 5e-2),
    ((4, 1024, 64, 1, 64, 128), 256, "bfloat16", "float32", False, 5e-2),   # mamba2 serve
    # "wg": ragged S, G > 1, h0, dt in bf16, P and N of 64 and 128
    ((2, 333, 4, 2, 64, 64), 64, "bfloat16", "float32", True, 5e-2),
    ((1, 300, 4, 2, 128, 128), 64, "bfloat16", "bfloat16", False, 5e-2),
    ((2, 517, 4, 1, 128, 64), 64, "bfloat16", "float32", True, 5e-2),
])
def test_k2_kernel_matches_plain_on_card(shape, chunk, dtype, dt_dtype, with_h0, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is CUDA C++ with no CPU mode")
    B, S, H, G, P, N = shape
    serve = S == 1024
    g = torch.Generator(device="cuda").manual_seed(7)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x = mk(B, H, S, P).to(getattr(torch, dtype))
    dt = F.softplus(mk(B, H, S) - (4.6 if serve else 0.0)).to(getattr(torch, dt_dtype))
    A = -torch.ones(H, device="cuda") if serve else -torch.exp(mk(H) * 0.5)
    Bi = (mk(B, G, S, N) * 0.5).to(x.dtype)
    Ci = (mk(B, G, S, N) * 0.5).to(x.dtype)
    h0 = mk(B, H, P, N) * 0.5 if with_h0 else None
    variant = ks.k2_variant(x.dtype, P, N)
    wg = P in (64, 128) and N in (64, 128)
    assert variant == (("wg" if wg else "tc") if dtype == "bfloat16" else "fma")
    before = ks.ssd_scan_hmajor.launches
    by_variant = ks.ssd_scan_hmajor.launches_by_variant[variant]
    y, st = ks.ssd_scan_hmajor(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ks.ssd_scan_hmajor.launches == before + 1
    assert ks.ssd_scan_hmajor.launches_by_variant[variant] == by_variant + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    refs = [ks.ssd_scan_hmajor_plain(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)]
    if dtype == "float32":
        refs.append(ssd_ref(x, dt, A, Bi, Ci, h0=h0))
    runs = [(y, st)]
    if variant == "wg":        # every segment count the call can take up to 5, and the last
        chunks = -(-S // 64)
        runs += [ks._launch(x, dt, A, Bi, Ci, h0, "wg", torch.bfloat16, segments=n)
                 for n in sorted(set(range(1, min(chunks, 5) + 1)) | {chunks})]
        again = ks.ssd_scan_hmajor(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        assert torch.equal(again[0], y) and torch.equal(again[1], st)     # no atomics
    for y_run, st_run in runs:
        for yr, sr in refs:
            torch.testing.assert_close(y_run.float(), yr.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(st_run, sr, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k2_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is CUDA C++ with no CPU mode")
    x = torch.zeros(1, 2, 8, 16, device="cuda")
    dt, A = torch.zeros(1, 2, 8, device="cuda"), -torch.ones(2, device="cuda")
    Bi = torch.zeros(1, 1, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ks.ssd_scan_hmajor(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bi, Bi)
    big = torch.zeros(1, 1, 8, 256, device="cuda")
    with pytest.raises(ValueError, match="d_state"):
        ks.ssd_scan_hmajor(x, dt, A, big, big)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 200, 2, 1, 128, 64), (2, 300, 4, 1, 64, 128)])
def test_k2_tc_f32_y_rounds_to_its_bf16_y(shape):
    """The "tc" kernel writing y in f32 (y before output rounding) does the
    same arithmetic as the one writing bf16: rounding it gives the bf16 y.
    (At these shapes bf16 calls take "wg", so "tc" is launched by name.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is CUDA C++ with no CPU mode")
    B, S, H, G, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(8)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x = mk(B, H, S, P).to(torch.bfloat16)
    dt, A = F.softplus(mk(B, H, S) - 4.6), -torch.ones(H, device="cuda")
    Bi, Ci = ((mk(B, G, S, N) * 0.5).to(torch.bfloat16) for _ in range(2))
    y, st = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16)
    y32, st32 = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.float32)
    torch.cuda.synchronize()
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16), y) and torch.equal(st32, st)
    yr, _ = ks.ssd_scan_hmajor_plain(x.float(), dt, A, Bi.float(), Ci.float())
    torch.testing.assert_close(y32, yr, atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
def test_tc_kernels_fit_two_blocks_per_sm_at_the_serve_head_dims():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the occupancy query runs on the card")
    assert fa.occupancy("tc", 128)[1] >= 2         # internlm2-1.8b before "wg"
    assert ks.occupancy("tc", 64)[1] >= 2          # mamba2-1.3b: 256 blocks in one wave
    for hd in (64, 128):                           # wg: one block of 3 warpgroups per SM
        smem, blocks = fa.occupancy("wg", hd)
        assert smem > 0 and blocks == 1
    for P in (64, 128):                            # K2 wg: what k2_segments counts on
        smem, blocks = ks.occupancy("wg", P)
        assert smem > 0 and blocks == ks.WG_BLOCKS_PER_SM[P]
    for query, dim in [(fa.occupancy, 256), (ks.occupancy, 128), (fa.occupancy, 128),
                       (ks.occupancy, 64)]:
        for variant in ("tc", "fma"):
            smem, blocks = query(variant, dim)
            assert smem > 0 and blocks >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_h0", [((2, 37, 4, 2, 16, 32), False),
                                           ((1, 200, 2, 1, 128, 64), True),
                                           ((2, 300, 4, 1, 64, 128), False)])
def test_k2_tc_bf16_operands_matches_plain(shape, with_h0):
    """The tensor-core kernel with every product on bf16 operands (the
    measured alternative to tf32 att @ x and C @ state^T) agrees with the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is CUDA C++ with no CPU mode")
    B, S, H, G, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(9)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x = mk(B, H, S, P).to(torch.bfloat16)
    dt, A = F.softplus(mk(B, H, S)), -torch.exp(mk(H) * 0.5)
    Bi, Ci = ((mk(B, G, S, N) * 0.5).to(torch.bfloat16) for _ in range(2))
    h0 = mk(B, H, P, N) * 0.5 if with_h0 else None
    y, st = ks._launch(x, dt, A, Bi, Ci, h0, "tc", torch.bfloat16, tf32=False)
    yr, sr = ks.ssd_scan_hmajor_plain(x, dt, A, Bi, Ci, h0=h0)
    torch.testing.assert_close(y.float(), yr.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(st, sr, atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [106, 2120])
def test_bootstrap_on_card_matches_numpy(k):
    """The statistics engine's torch backend on the card (k = 2,120 spans
    several gather chunks) against the NumPy path, at
    tests/test_stats_batch.py's tolerance; a ragged NaN/inf set too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the torch stats backend has no CPU fallback")
    import numpy as np
    from repro_torch.core import stats
    rng = np.random.default_rng(k)
    arrays = [rng.normal(0.02, 0.05, 45) for _ in range(k)]
    arrays += [rng.normal(0, 1, n) for n in (44, 10, 0)]
    arrays[1][5], arrays[2][0] = np.nan, np.inf
    got = stats.bootstrap_median_ci_batch(arrays, n_boot=1000, seed=0, backend="torch",
                                          device="cuda")
    ref = stats.bootstrap_median_ci_batch(arrays, n_boot=1000, seed=0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True)
