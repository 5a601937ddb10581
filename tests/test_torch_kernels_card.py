"""K1, K2 and K3 on the card against their plain versions.

Every f32 case has a bf16 twin: bf16 runs a tensor-core variant wherever
``k1_variant`` / ``k2_variant`` choose it (K1: "wg" at hd 64 and 128, "tc"
at the other multiples of 16; hd 72 stays on the CUDA-core "fma" kernel;
K2: "wg" at P and N of 64 and 128, "tc" at the other bf16 shapes), and each
call is counted under its variant.  Where K1 takes "wg", its "tc" kernel is
held on the same inputs too; where K2 takes "wg", it is held again at
several segment counts, twice for the same bits, and beside "tc".  At the
prefill shapes of the families and cells the port serves (whisper's
encoder, llava's prefill, Jamba's mixer, the prefill_32k cells, a mamba2
train microbatch on the model's own inputs) each bf16 output row is also
held within the tolerance of its own norm (``tests/_torch_card.py``).

K3 (decode attention) is held against the dot path it replaces, at the
decode shapes of internlm2-1.8b's two benchmark cells (in the int form and
in the device-length form a replayed step launches, and with scores as
peaked as the serve model's init makes them) and at the other head dims,
query groups and types it instantiates; a served decode step launches it
once or twice per layer.

This file needs no jax, so that it also runs on a machine with a CUDA card
and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_card.py

Without a card every test skips (a CUDA kernel has no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from _torch_card import assert_rows_within, skip_without_card  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
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
# tests/test_kernels.py:16-22's shapes, causal and not, beside the cases above
K1_MORE_TWINS = [((2, 128, 128, 4, 2, 64), dict(causal=False)),
                 ((1, 257, 129, 2, 2, 256), dict(causal=True))] + [
    (shape, dict(causal=causal)) for shape in [(1, 100, 100, 4, 4, 128), (2, 64, 64, 8, 2, 32),
                                               (1, 128, 256, 4, 1, 64)]
    for causal in (True, False)]
# bf16 only: the ragged, windowed and kv_valid cases again at the head dims
# "wg" takes, and the serve shape with q and k at the std the serve model's
# init gives them (``q_std``, scores of std ~128: each softmax near an argmax)
K1_MORE_BF16 = [
    ((1, 128, 128, 4, 4, 64), dict(causal=True)),
    ((2, 300, 300, 8, 2, 128), dict(causal=True, window=37)),
    ((2, 77, 200, 4, 2, 64), dict(causal=False, kv_valid=150)),
    ((1, 257, 129, 2, 2, 128), dict(causal=True, kv_valid=100)),
    ((4, 1024, 1024, 16, 8, 128), dict(causal=True, q_std=11.3)),
]
# the prefill shapes of the families and cells the port serves, each output
# row also held within the tolerance of its own norm (``row_share``):
# whisper-medium's encoder, llava-next-34b's prefill (2,880 image tokens +
# 1,024), internlm2-1.8b at prefill_32k (batch 1)
K1_PATHS = [((4, 1500, 1500, 16, 16, 64), "float32", dict(causal=False)),
            ((4, 1500, 1500, 16, 16, 64), "bfloat16", dict(causal=False)),
            ((4, 3904, 3904, 56, 8, 128), "bfloat16", dict(causal=True)),
            ((1, 32768, 32768, 16, 8, 128), "bfloat16", dict(causal=True))]


def _k1_plain_by_rows(q, k, v, causal=True, block=2048):
    """K1's plain version (``attention_ref``'s arithmetic: GQA by repeat, f32
    scores, mask, softmax, f32 p.v) a block of query rows at a time, so that
    S = 32,768 needs no [S, S] score matrix."""
    B, H, Sq, hd = q.shape
    g = H // k.shape[1]
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    out = torch.empty_like(q)
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    for r0 in range(0, Sq, block):
        r1 = min(r0 + block, Sq)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(), kf) * hd ** -0.5
        if causal:
            q_pos = torch.arange(r0, r1, device=q.device)[:, None]
            s = torch.where(k_pos <= q_pos, s, -1e30)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                                        vf).to(q.dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,kw,tol", [
    (shape, dtype, kw, K1_TOL[dtype]) for shape, kw in K1_CASES for dtype in K1_TOL
] + [
    ((4, 1024, 1024, 16, 8, 128), "bfloat16", dict(causal=True), 3e-2),
] + [(shape, dtype, kw, K1_TOL[dtype]) for shape, kw in K1_MORE_TWINS for dtype in K1_TOL]
  + [(shape, "bfloat16", kw, 3e-2) for shape, kw in K1_MORE_BF16]
  + [(shape, dtype, kw, K1_TOL[dtype]) for shape, dtype, kw in K1_PATHS])
def test_k1_kernel_matches_plain_on_card(shape, dtype, kw, tol):
    skip_without_card("K1 is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(kw)
    q_std = kw.pop("q_std", 1.0)
    B, Sq, Skv, H, K, hd = shape
    rows = dtype == "bfloat16" and (shape, dtype, kw) in K1_PATHS
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(getattr(torch, dtype))
               for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd)))
    if q_std != 1.0:
        q, k = (q.float() * q_std).to(q.dtype), (k.float() * q_std).to(k.dtype)
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
    plain = _k1_plain_by_rows if Sq > 8192 else fa.flash_attention_hmajor_plain
    ref = plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if rows:
        assert_rows_within(out, ref, tol)
    if variant == "wg":
        full = dict(dict(causal=True, window=0, kv_valid=None, softmax_scale=None), **kw)
        tc = fa._launch(q, k, v, "tc", **full)
        torch.cuda.synchronize()
        torch.testing.assert_close(tc.float(), ref.float(), atol=tol, rtol=tol)
        if rows:
            assert_rows_within(tc, ref, tol)


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
# the Mamba-2 prefill shapes of the paths the port serves (x, B and C drawn
# as the serve model gives them, S >= 1024), each bf16 output row also held
# within the tolerance of its own norm: Jamba's mixer, mamba2-1.3b at
# prefill_32k (batch 1)
K2_PATHS = [((4, 1024, 128, 1, 128, 128), 256, "float32", "float32", False, 1e-4),
            ((4, 1024, 128, 1, 128, 128), 256, "bfloat16", "float32", False, 5e-2),
            ((1, 32768, 64, 1, 64, 128), 256, "bfloat16", "float32", False, 5e-2)]


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
    ((1, 300, 4, 2, 128, 128), 64, "bfloat16", "float32", False, 5e-2),
    ((2, 517, 4, 1, 128, 64), 64, "bfloat16", "bfloat16", True, 5e-2),
    ((1, 1000, 8, 1, 64, 128), 64, "bfloat16", "float32", True, 5e-2),
] + K2_PATHS)
def test_k2_kernel_matches_plain_on_card(shape, chunk, dtype, dt_dtype, with_h0, tol):
    """Where a call takes "wg", the same inputs go through "wg" again at
    several segment counts, the public call twice (the same bits: no
    atomics), and through "tc", each held the same way; the f32 cases and
    the bf16 ones "wg" takes below the serve lengths are also held to the
    step-by-step ``ssd_ref``."""
    skip_without_card("K2 is CUDA C++ with no CPU mode")
    B, S, H, G, P, N = shape
    serve = S >= 1024
    rows = (shape, chunk, dtype, dt_dtype, with_h0, tol) in K2_PATHS and dtype == "bfloat16"
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
    if dtype == "float32" or (variant == "wg" and not serve):
        refs.append(ssd_ref(x, dt, A, Bi, Ci, h0=h0))
    runs = [(y, st)]
    if variant == "wg":        # every segment count the call can take up to 5, and the last
        chunks = -(-S // 64)
        runs += [ks._launch(x, dt, A, Bi, Ci, h0, "wg", torch.bfloat16, segments=n)
                 for n in sorted(set(range(1, min(chunks, 5) + 1)) | {chunks})]
        again = ks.ssd_scan_hmajor(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        assert torch.equal(again[0], y) and torch.equal(again[1], st)     # no atomics
        runs.append(ks._launch(x, dt, A, Bi, Ci, h0, "tc", torch.bfloat16))
    for y_run, st_run in runs:
        assert y_run.dtype == x.dtype and st_run.dtype == torch.float32
        for yr, sr in refs:
            torch.testing.assert_close(y_run.float(), yr.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(st_run, sr, atol=tol, rtol=tol)
            if rows:
                assert_rows_within(y_run, yr, tol)
                assert_rows_within(st_run, sr, tol)


def _mamba2_train_ssd_inputs():
    """K2's inputs as a mamba2-1.3b train microbatch gives them: the forward
    of the full-depth model (seeded random bf16 weights) on 2 x 4,096
    synthetic tokens, keeping the SSD call whose chunks decay most (the
    largest sum of dt |A| over a chunk's 256 positions; the gradient's exp
    overflow came from these sums).  Returns (x, dt, A, B, C) head-major."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.lm import LM
    from repro_torch.train import data as data_mod
    from repro_torch.train.train_step import make_loss_fn
    cfg = get_config("mamba2-1.3b")
    lm = LM(cfg, device="cuda", seed=0)
    ds = data_mod.SyntheticDataset(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=4096, global_batch=2, accum_steps=1), cfg)
    mb = {k: v[0] for k, v in data_mod.batch_to_device(ds.batch(0), "cuda").items()}
    best = {"decay": -1.0}
    real = ssm_mod.ssd_scan_hmajor

    def grab(x, dt, A, B, C, *, chunk, h0=None):
        decay = float((dt * -A[:, None]).unflatten(-1, (-1, chunk)).sum(-1).max())
        if decay > best["decay"]:
            best.update(decay=decay, inputs=tuple(t.clone() for t in (x, dt, A, B, C)))
        return real(x, dt, A, B, C, chunk=chunk, h0=h0)

    ssm_mod.ssd_scan_hmajor = grab
    try:
        with torch.no_grad():
            make_loss_fn(lm)(mb)
    finally:
        ssm_mod.ssd_scan_hmajor = real
    del lm
    torch.cuda.empty_cache()
    return best["inputs"]


@pytest.mark.cuda
def test_k2_matches_plain_on_a_mamba2_train_microbatch_on_card():
    """K2 on the inputs a mamba2-1.3b train microbatch (2 x 4,096) gives it,
    in bf16 as the model gives them and in f32 cast up, each bf16 output row
    also within the tolerance of its own norm."""
    skip_without_card("K2 is CUDA C++ with no CPU mode")
    inputs = _mamba2_train_ssd_inputs()
    assert tuple(inputs[0].shape) == (2, 64, 4096, 64)          # x [B, H, S, P]
    assert tuple(inputs[3].shape) == (2, 1, 4096, 128)          # B [B, G, S, N]
    for dtype, tol in K2_TOL.items():
        x, dt, A, Bi, Ci = (t.to(getattr(torch, dtype)) if t.dtype == torch.bfloat16 else t
                            for t in inputs)
        got = ks.ssd_scan_hmajor(x, dt, A, Bi, Ci)
        want = ks.ssd_scan_hmajor_plain(x, dt, A, Bi, Ci, chunk=256)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
            if dtype == "bfloat16":
                assert_rows_within(a, b, tol)


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
@pytest.mark.parametrize("shape", [(1, 200, 2, 1, 128, 64), (2, 300, 4, 1, 64, 128),
                                   (4, 1024, 64, 1, 64, 128)])
def test_k2_tc_f32_y_rounds_to_its_bf16_y(shape):
    """The "tc" kernel writing y in f32 (y before output rounding) does the
    same arithmetic as the one writing bf16: rounding it gives the bf16 y.
    (At these shapes bf16 calls take "wg", so "tc" is launched by name.)
    At mamba2-1.3b's serve shape its operand rounding alone, y in f32
    against the f32 plain version, stays within half the tolerance."""
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
    if shape == (4, 1024, 64, 1, 64, 128):
        assert float((y32 - yr).abs().max()) <= 5e-2 / 2


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


K3_CASES = [   # (B, S, H, K, hd), dtype, valid length, window: bf16 / f16 at K1's 3e-2
    ((4, 32_784, 16, 8, 128), "bfloat16", 24_577, None),    # internlm2-1.8b.longdoc
    ((64, 1_088, 16, 8, 128), "bfloat16", 1_088, None),     # internlm2-1.8b.short
    ((64, 1_088, 16, 8, 128), "bfloat16", 300, None),
    ((2, 300, 16, 16, 64), "bfloat16", 290, None),          # G 1
    ((2, 900, 64, 8, 128), "bfloat16", 777, 100),           # G 8, a window
    ((2, 900, 56, 8, 128), "bfloat16", 877, None),          # G 7 (llava)
    ((2, 600, 32, 2, 16), "bfloat16", 555, None),           # G 16, hd 16
    ((3, 400, 8, 4, 256), "bfloat16", 399, 64),             # hd 256 (gemma3)
    ((3, 400, 8, 4, 32), "float16", 333, None),
    ((1, 50, 4, 2, 64), "bfloat16", 50, None),              # one split
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,valid,window", K3_CASES)
def test_k3_matches_the_dot_path_on_card(shape, dtype, valid, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is CUDA C++ with no CPU mode")
    from repro_torch.models import attention as ta
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, K, hd = shape
    g = torch.Generator(device="cuda").manual_seed(10)
    # q at 3 N(0, 1): scores of std ~3, so some rows are peaked and some flat
    q = (3 * torch.randn(B, 1, H, hd, generator=g, device="cuda")).to(getattr(torch, dtype))
    cache = torch.randn(2, 2, B, S, K, hd, generator=g, device="cuda").to(q.dtype)
    k, v = cache[1, 0], cache[1, 1]                 # a layer's slice of a stacked cache
    kw = dict(causal=False, window=window, q_offset=valid - 1, kv_valid_len=valid)
    assert ta.k3_refusal(q, k, v, impl="dot", **kw) is None
    lo = max(0, valid - window) if window else 0
    _, splits, _ = da._split(B, H, K, valid - lo,
                             torch.cuda.get_device_properties(0).multi_processor_count)
    before = da.decode_attention.launches
    out = ta.attention(q, k, v, impl="dot", **kw)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + (1 if splits == 1 else 2)
    assert out.dtype == q.dtype and out.shape == q.shape
    want = ta._attention_dot(q, k, v, **kw)
    plain = da.decode_attention_plain(q, k, v, lo=lo, hi=valid)
    runs = [out] + [da._launch(q, k, v, lo=lo, hi=valid, splits=n) for n in (1, 3)]
    for got in runs:
        for ref in (want, plain):
            torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=3e-2)
            # and each output row within 3e-2 of its own norm: an average over
            # thousands of keys is as small as the element-wise atol
            err = (got.float() - ref.float()).norm(dim=-1)
            assert torch.all(err <= 3e-2 * ref.float().norm(dim=-1)), float(
                (err / ref.float().norm(dim=-1)).max())


K3_CELLS = {"internlm2-1.8b.longdoc": ((4, 32_784, 16, 8, 128), 24_577),
            "internlm2-1.8b.short": ((64, 1_088, 16, 8, 128), 1_088)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,peaked,form", [
    (cell, peaked, form) for cell in K3_CELLS for peaked in (False, True)
    for form in ("int", "device") if peaked or form == "device"])
def test_k3_through_the_rule_at_the_cells_decode_steps(cell, peaked, form):
    """K3 through ``models.attention.attention`` at the decode steps of
    internlm2-1.8b's two benchmark cells (the 24,576-token batch's median
    step, the longest short request's last), in the int form and in the
    form a replayed decode step launches (the valid length one int64 on the
    card, the grid cut over all S keys, the splits past the length empty);
    ``peaked`` puts q and k at the std the serve model's init gives them
    (11.3 each: scores of std ~128).  Launches, the dot path it replaces and
    its plain version, each output row within 3e-2 of its own norm."""
    skip_without_card("K3 is CUDA C++ with no CPU mode")
    from repro_torch.models import attention as ta
    torch.backends.cuda.matmul.allow_tf32 = False
    (B, S, H, K, hd), valid = K3_CELLS[cell]
    g = torch.Generator(device="cuda").manual_seed(40 + 2 * peaked + (form == "device"))
    q = ((11.3 * 11.3 if peaked else 1.0)
         * torch.randn(B, 1, H, hd, generator=g, device="cuda")).to(torch.bfloat16)
    cache = torch.randn(2, 2, B, S, K, hd, generator=g, device="cuda").to(q.dtype)
    k, v = cache[1, 0], cache[1, 1]                 # a layer's slice of a stacked cache
    n = valid if form == "int" else torch.tensor([valid], device="cuda")
    kw = dict(causal=False, q_offset=n - 1, kv_valid_len=n)      # as LM.decode passes them
    assert ta.k3_refusal(q, k, v, impl="dot", **kw) is None
    _, splits, _ = da._split(B, H, K, valid if form == "int" else S,
                             torch.cuda.get_device_properties(0).multi_processor_count)
    before = da.decode_attention.launches
    out = ta.attention(q, k, v, impl="dot", **kw)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + (1 if splits == 1 else 2)
    dot = ta._attention_dot(q, k, v, causal=False, q_offset=valid - 1, kv_valid_len=valid)
    plain = (da.decode_attention_plain(q, k, v, lo=0, hi=valid) if form == "int" else
             da.decode_attention_plain(q, k, v, lo=0, hi=S, valid=n))
    for ref in (dot, plain):
        torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=3e-2)
        assert_rows_within(out, ref, 3e-2)


@pytest.mark.cuda
def test_k3_blocks_per_sm_are_what_the_split_rule_counts_on():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the occupancy query runs on the card")
    for hd in da.HEAD_DIMS:
        for gt, blocks in da.BLOCKS_PER_SM.items():
            assert da.occupancy(hd, gt) == blocks, (hd, gt)


@pytest.mark.cuda
def test_k3_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is CUDA C++ with no CPU mode")
    q = torch.zeros(1, 1, 2, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or all float16"):
        da.decode_attention(q.float(), k.float(), k.float(), lo=0, hi=8)
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros(1, 8, 1, 96, device="cuda", dtype=torch.bfloat16)
        da.decode_attention(torch.zeros(1, 1, 2, 96, device="cuda", dtype=torch.bfloat16),
                            wide, wide, lo=0, hi=8)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros(1, 8, 1, 72, device="cuda", dtype=torch.bfloat16)[..., 4:68]
        da.decode_attention(q, odd, odd, lo=0, hi=8)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), k, lo=0, hi=8)
    with pytest.raises(ValueError, match="one device"):
        da.decode_attention(q.cpu(), k, k, lo=0, hi=8)
    with pytest.raises(ValueError, match="key range"):
        da.decode_attention(q, k, k, lo=0, hi=9)


@pytest.mark.cuda
def test_a_served_internlm2_decode_step_launches_k3_per_layer():
    """internlm2-1.8b at full width cut to 2 layers: one profiled decode step
    launches K3 once or twice a layer, and each layer's "attention_core"
    span notes no cast bytes and holds a "k3" span with the bytes K3 reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is CUDA C++ with no CPU mode")
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import scope
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), num_layers=2)
    lm = LM(cfg, device="cuda", seed=0)
    B, S = 4, 1_000
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill")
        cache = serve.grow_cache(cfg, out["cache"], S + 8)
        tok = torch.argmax(out["logits"][:, -1], -1)[:, None]
        scope.clear()
        before = da.decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            lm.decode(cache, tok, S)
            torch.cuda.synchronize()
    launches = da.decode_attention.launches - before
    spans = scope.spans()
    scope.clear()
    cores = [s for s in spans if s.tag == "attention_core"]
    k3 = [s for s in spans if s.tag == "k3"]
    assert launches in (cfg.num_layers, 2 * cfg.num_layers)
    assert len(cores) == len(k3) == cfg.num_layers
    assert all(s.attrs == {"cast_bytes": 0} for s in cores)
    assert sorted(s.parent for s in k3) == sorted(s.id for s in cores)
    assert all(s.attrs["bytes"] == 2 * B * (S + 1) * cfg.num_kv_heads * cfg.head_dim * 2
               for s in k3)
