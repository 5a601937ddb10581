"""A CPU model of where the tensor-core variants of K1 and K2 round to bf16,
held against the JAX references.

The tensor-core kernels (``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu``,
variant "tc") multiply bf16 operands with fp32 sums, so their results differ
from the Pallas kernels only where an fp32 intermediate becomes a bf16
operand:

* K1: the probabilities P, rounded to bf16 before P V (the reference keeps
  them in f32); the row sums use the unrounded P.  Online softmax runs over
  the kernel's sub-tiles of the reference's 128-key tiles: 64 keys in the
  mma.sync kernel ("tc"), the whole 128 in the wgmma kernel ("wg", ``sub=
  WG_SUB``).
* K2: the masked tile att, the state operand of C state^T and B .* w, all
  rounded to bf16, over the kernel's own 64-row chunks; the carried state,
  cum, the decays and w stay fp32.  The kernel on the serve path takes att
  and the state as tf32 operands instead (``operand=_tf32``): on bf16
  operands the serve shape's y used more than half of the tolerance before
  it is stored (PERF.md).
* K2 "wg" (``k2_wg_model``): the sequence cut into segments of whole
  64-row chunks, the segments' states from zero, a pass that carries the
  state across them, then each segment's outputs from its incoming state;
  att, the state operand and x .* w enter every product as hi + lo bf16
  pairs (``_split``, about 16 significant bits), so the split's algebra is
  exact in f32 (``operand`` = identity) and its rounding far under the
  tolerance.

The models below follow those steps in fp32 on the CPU and are compared,
on numpy-seeded bf16 inputs, with ``repro.kernels.ref`` and with the Pallas
kernels in interpret mode at the bf16 tolerances of tests/test_kernels.py
(3e-2 for K1, 5e-2 for K2).  Nothing in the package imports these models;
the kernels themselves are held against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_hmajor as pallas_flash  # noqa: E402
from repro.kernels.ref import attention_ref, ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_hmajor as pallas_ssd  # noqa: E402

REF_TILE, SUB, CHUNK = 128, 64, 64     # K1's reference tile and sub-tile; K2's chunk
WG_SUB = 128                           # K1 "wg": the sub-tile is the reference tile


def _bf16(a):
    """Round a float32 tensor to bf16 values, kept in float32."""
    return a.to(torch.bfloat16).float()


def k1_tc_model(q, k, v, *, causal=True, window=0, kv_valid=None, sub=SUB):
    """q [B,H,Sq,hd], k/v [B,K,Skv,hd] (bf16 values in f32) -> f32 output,
    with the online softmax over sub-tiles of ``sub`` keys."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scale = hd ** -0.5
    kv_valid = Skv if kv_valid is None else min(kv_valid, Skv)
    bq_ref = min(REF_TILE, -(-Sq // 8) * 8)
    bkv_ref = min(REF_TILE, -(-Skv // 8) * 8)
    out = torch.zeros_like(q)
    for q0 in range(0, Sq, sub):
        rows = torch.arange(q0, q0 + sub)[:, None]
        qb = torch.nn.functional.pad(q[:, :, q0:q0 + sub], (0, 0, 0, q0 + sub - min(Sq, q0 + sub)))
        m = torch.full((B, H, sub, 1), -1e30)
        l = torch.zeros((B, H, sub, 1))
        acc = torch.zeros((B, H, sub, hd))
        q_lo = q0 // bq_ref * bq_ref
        for jt in range(-(-Skv // bkv_ref)):
            k_lo = jt * bkv_ref
            needed = k_lo < kv_valid
            if causal:
                needed &= k_lo <= q_lo + bq_ref - 1
            if window > 0:
                needed &= q_lo - (k_lo + bkv_ref - 1) < window
            if not needed:
                continue
            for c0 in range(0, bkv_ref, sub):
                n = min(sub, bkv_ref - c0)
                kb = k_lo + c0
                cols = torch.arange(kb, kb + sub)[None, :]
                kt = torch.zeros((B, H, sub, hd))
                vt = torch.zeros((B, H, sub, hd))
                hi = min(Skv, kb + sub)
                if hi > kb:
                    kt[:, :, :hi - kb] = k[:, :, kb:hi]
                    vt[:, :, :hi - kb] = v[:, :, kb:hi]
                s = torch.einsum("bhqd,bhkd->bhqk", qb, kt) * scale
                ok = cols < kv_valid
                if causal:
                    ok = ok & (cols <= rows)
                if window > 0:
                    ok = ok & (rows - cols < window)
                s = torch.where(ok, s, torch.tensor(-1e30))
                s = torch.where(cols - kb >= n, torch.tensor(-float("inf")), s)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", _bf16(p), vt)
                m = m_new
        res = acc / l.clamp(min=1e-30)
        out[:, :, q0:q0 + sub] = res[:, :, :min(sub, Sq - q0)]
    return out


def _tf32(a):
    """Round a float32 tensor to tf32 values (10 mantissa bits, to nearest,
    ties away from zero, as cvt.rna.tf32.f32), kept in float32."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def k2_tc_model(x, dt, A, B_in, C_in, operand=_bf16):
    """x [B,H,S,P], dt [B,H,S], A [H], B/C [B,G,S,N] -> (y, state), f32.
    ``operand`` rounds att and the state operand; B .* w is rounded to bf16."""
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    Bh = B_in.repeat_interleave(H // G, dim=1)
    Ch = C_in.repeat_interleave(H // G, dim=1)
    pad = (-S) % CHUNK
    xf = torch.nn.functional.pad(x, (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt, (0, pad))
    Bf = torch.nn.functional.pad(Bh, (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Ch, (0, 0, 0, pad))
    a = A[None, :, None]
    h = torch.zeros((Bz, H, P, N))
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool))
    ys = []
    for c0 in range(0, S + pad, CHUNK):
        xc, dc = xf[:, :, c0:c0 + CHUNK], dtf[:, :, c0:c0 + CHUNK]
        Bc, Cc = Bf[:, :, c0:c0 + CHUNK], Cf[:, :, c0:c0 + CHUNK]
        cum = torch.cumsum(dc * a, dim=-1)
        total = cum[..., -1:]
        cb = torch.einsum("bhin,bhjn->bhij", Cc, Bc)
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], torch.tensor(0.0))
        att = torch.where(tri, cb * torch.exp(diff) * dc[..., None, :], torch.tensor(0.0))
        y = torch.exp(cum)[..., None] * torch.einsum("bhqn,bhpn->bhqp", Cc, operand(h))
        y = y + torch.einsum("bhij,bhjp->bhip", operand(att), xc)
        w = torch.exp(total - cum) * dc
        h = h * torch.exp(total)[..., None] + torch.einsum(
            "bhjp,bhjn->bhpn", xc, _bf16(Bc * w[..., None]))
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S], h


def _split(a):
    """a as the hi + lo bf16 pair the "wg" kernel feeds the tensor cores
    (``split_bf16``): hi = bf16(a), lo = bf16(a - hi), summed in f32."""
    hi = _bf16(a)
    return hi + _bf16(a - hi)


def _k2_wg_chunks(xf, dtf, A, Bf, Cf, h, c_lo, c_hi, operand, outputs, att_operand):
    """The "wg" chunk recurrence over chunks [c_lo, c_hi) from state h, on
    inputs padded to whole chunks (B, C per head): (the chunks' y, or [] for
    the states kernel, the state after them, their decay sum [B,H,1])."""
    a = A[None, :, None]
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool))
    ys, decay = [], 0.0
    for c in range(c_lo, c_hi):
        rows = slice(c * CHUNK, (c + 1) * CHUNK)
        xc, dc, Bc, Cc = xf[:, :, rows], dtf[:, :, rows], Bf[:, :, rows], Cf[:, :, rows]
        cum = torch.cumsum(dc * a, dim=-1)
        total = cum[..., -1:]
        if outputs:
            cb = torch.einsum("bhin,bhjn->bhij", Cc, Bc)
            diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], torch.tensor(0.0))
            att = torch.where(tri, cb * torch.exp(diff) * dc[..., None, :], torch.tensor(0.0))
            y = torch.exp(cum)[..., None] * torch.einsum("bhqn,bhpn->bhqp", Cc, operand(h))
            ys.append(y + torch.einsum("bhij,bhjp->bhip", att_operand(att), xc))
        w = torch.exp(total - cum) * dc
        h = h * torch.exp(total)[..., None] + torch.einsum(
            "bhjp,bhjn->bhpn", operand(xc * w[..., None]), Bc)
        decay = decay + total
    return ys, h, decay


def k2_wg_model(x, dt, A, B_in, C_in, h0=None, segments=1, operand=_split, att_operand=None):
    """x [B,H,S,P], dt [B,H,S], A [H], B/C [B,G,S,N] -> (y, state), f32, as
    the "wg" kernel computes them over ``segments`` segments (segment s:
    chunks [s nc / segments, (s + 1) nc / segments)).  ``operand`` rounds
    att, the state operand and x .* w; ``att_operand``, if given, att
    instead."""
    att_operand = att_operand or operand
    Bz, H, S, P = x.shape
    G, N = B_in.shape[1], B_in.shape[3]
    pad = (-S) % CHUNK
    xf = torch.nn.functional.pad(x, (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt, (0, pad))
    Bf, Cf = (torch.nn.functional.pad(t.repeat_interleave(H // G, dim=1), (0, 0, 0, pad))
              for t in (B_in, C_in))
    nc = (S + pad) // CHUNK
    bounds = [s * nc // segments for s in range(segments + 1)]
    zero = torch.zeros((Bz, H, P, N))
    h_in = [zero if h0 is None else h0]
    for s in range(segments - 1):          # the states kernel, then the pass
        _, seg_state, decay = _k2_wg_chunks(xf, dtf, A, Bf, Cf, zero, bounds[s], bounds[s + 1],
                                            operand, False, att_operand)
        h_in.append(torch.exp(decay)[..., None] * h_in[-1] + seg_state)
    ys = []
    for s in range(segments):              # the outputs kernel
        y, h, _ = _k2_wg_chunks(xf, dtf, A, Bf, Cf, h_in[s], bounds[s], bounds[s + 1], operand,
                                True, att_operand)
        ys += y
    return torch.cat(ys, dim=2)[:, :, :S], h


def _qkv(B, Sq, Skv, H, K, hd, seed, std=1.0):
    """numpy-seeded inputs, rounded to bf16 (returned as f32 numpy)."""
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32) for s in
            ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd))]
    arrs[0] *= std
    arrs[1] *= std
    return [_bf16(torch.from_numpy(a)).numpy() for a in arrs]


K1_CASES = [   # name, (B, Sq, Skv, H, K, hd), kwargs, q/k std
    ("causal", (1, 200, 200, 4, 2, 64), dict(causal=True), 1.0),
    ("ragged_non_causal", (1, 130, 75, 2, 2, 32), dict(causal=False), 1.0),
    ("windowed_gqa_hd96", (1, 150, 150, 4, 2, 96), dict(causal=True, window=37), 1.0),
    ("kv_valid_hd16", (2, 40, 96, 4, 2, 16), dict(causal=False, kv_valid=50), 1.0),
    ("peaked_scores", (1, 256, 256, 2, 1, 128), dict(causal=True), 11.3),
]


@pytest.mark.parametrize("name,shape,kw,std", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_tc_rounding_within_tolerance_of_jax_ref(name, shape, kw, std):
    q, k, v = _qkv(*shape, seed=sum(map(ord, name)), std=std)
    model = k1_tc_model(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    ref = attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = _bf16(model).numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=3e-2, rtol=3e-2)
    # the model does round: it is not the f32 computation
    exact = attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    assert np.abs(model.numpy() - np.asarray(exact)).max() > 1e-6


@pytest.mark.parametrize("name,shape,kw,std", [K1_CASES[0], K1_CASES[2], K1_CASES[4]],
                         ids=["causal", "windowed_gqa_hd96", "peaked_scores"])
def test_k1_tc_rounding_within_tolerance_of_pallas_interpret(name, shape, kw, std):
    q, k, v = _qkv(*shape, seed=sum(map(ord, name)), std=std)
    model = k1_tc_model(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    ref = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True, **kw)
    np.testing.assert_allclose(_bf16(model).numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("name,shape,kw,std", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_wg_rounding_within_tolerance_of_jax_ref(name, shape, kw, std):
    """The "wg" kernel's rounding: the online softmax over whole 128-key
    reference tiles."""
    q, k, v = _qkv(*shape, seed=sum(map(ord, name)), std=std)
    model = k1_tc_model(*(torch.from_numpy(a) for a in (q, k, v)), sub=WG_SUB, **kw)
    ref = attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_bf16(model).numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)
    exact = attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    assert np.abs(model.numpy() - np.asarray(exact)).max() > 1e-6


@pytest.mark.parametrize("name,shape,kw,std", [K1_CASES[0], K1_CASES[2], K1_CASES[4]],
                         ids=["causal", "windowed_gqa_hd96", "peaked_scores"])
def test_k1_wg_rounding_within_tolerance_of_pallas_interpret(name, shape, kw, std):
    q, k, v = _qkv(*shape, seed=sum(map(ord, name)), std=std)
    model = k1_tc_model(*(torch.from_numpy(a) for a in (q, k, v)), sub=WG_SUB, **kw)
    ref = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True, **kw)
    np.testing.assert_allclose(_bf16(model).numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)


def _ssd_inputs(B, S, H, G, P, N, seed, serve, train=False):
    """numpy-seeded K2 inputs: x, B, C rounded to bf16; dt and A in f32.
    ``serve`` draws dt and A as the mamba2 serve path has them (small dt,
    A = -1); ``train`` as tests/test_kernels.py does but with A = -1.7, so
    that a 64-row chunk decays by ~87, as the largest chunk decay of a
    mamba2-1.3b train microbatch (PERF.md); otherwise as
    tests/test_kernels.py does."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, S, P)).astype(np.float32)
    z = r.standard_normal((B, H, S))
    dt = np.logaddexp(z - (4.6 if serve else 0.0), 0.0).astype(np.float32)
    A = (-np.ones(H) if serve else -np.full(H, 1.7) if train
         else -np.exp(r.standard_normal(H) * 0.5)).astype(np.float32)
    Bi = (r.standard_normal((B, G, S, N)) * 0.5).astype(np.float32)
    Ci = (r.standard_normal((B, G, S, N)) * 0.5).astype(np.float32)
    x, Bi, Ci = (_bf16(torch.from_numpy(a)).numpy() for a in (x, Bi, Ci))
    return x, dt, A, Bi, Ci


K2_CASES = [   # name, (B, S, H, G, P, N), serve regime
    ("test_kernels_regime", (1, 150, 4, 2, 32, 64), False),
    ("serve_regime", (2, 256, 4, 1, 64, 128), True),
    ("ragged_grouped", (2, 37, 4, 2, 16, 32), False),
]


def _jax_args(x, dt, A, Bi, Ci):
    bf = jnp.bfloat16
    return jnp.asarray(x, bf), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bi, bf), \
        jnp.asarray(Ci, bf)


@pytest.mark.parametrize("name,shape,serve", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_tc_rounding_within_tolerance_of_jax_ref(name, shape, serve):
    arrays = _ssd_inputs(*shape, seed=sum(map(ord, name)), serve=serve)
    y, st = k2_tc_model(*(torch.from_numpy(a) for a in arrays))
    yr, sr = ssd_ref(*_jax_args(*arrays))
    np.testing.assert_allclose(_bf16(y).numpy(), np.asarray(yr, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=5e-2, rtol=5e-2)
    # the model does round: it is not the f32 computation
    _, s_exact = ssd_ref(*(jnp.asarray(a) for a in arrays))
    assert np.abs(st.numpy() - np.asarray(s_exact)).max() > 1e-6


@pytest.mark.parametrize("name,shape,serve", K2_CASES[:2], ids=[c[0] for c in K2_CASES[:2]])
def test_k2_tc_rounding_within_tolerance_of_pallas_interpret(name, shape, serve):
    arrays = _ssd_inputs(*shape, seed=sum(map(ord, name)), serve=serve)
    y, st = k2_tc_model(*(torch.from_numpy(a) for a in arrays))
    yr, sr = pallas_ssd(*_jax_args(*arrays), chunk=64, interpret=True)
    np.testing.assert_allclose(_bf16(y).numpy(), np.asarray(yr, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("kernel", ["k1_peaked", "k2_serve_regime", "k2_serve_regime_tf32",
                                    "k1_wg_peaked", "k2_wg_serve_regime"])
def test_tc_rounding_uses_under_half_the_tolerance(kernel):
    """Before y is stored in bf16, the operand rounding alone uses less than
    half of the tolerance (the margin the design asks for), measured
    against the exact f32 oracle on the same bf16 inputs."""
    if kernel.startswith("k1"):
        q, k, v = _qkv(1, 256, 256, 2, 1, 128, seed=5, std=11.3)
        got = k1_tc_model(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                          sub=WG_SUB if "wg" in kernel else SUB).numpy()
        ref = np.asarray(attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
        tol = 3e-2
    else:
        arrays = _ssd_inputs(1, 1024, 4, 1, 64, 128, seed=6, serve=True)
        if "wg" in kernel:      # one segment, as k2_segments gives the serve shape
            y, _ = k2_wg_model(*(torch.from_numpy(a) for a in arrays), segments=1)
        else:
            y, _ = k2_tc_model(*(torch.from_numpy(a) for a in arrays),
                               operand=_tf32 if kernel.endswith("tf32") else _bf16)
        got = y.numpy()
        ref = np.asarray(jax.jit(ssd_ref)(*(jnp.asarray(a) for a in arrays))[0])
        tol = 5e-2
    share = np.abs(got - ref) / (tol + tol * np.abs(ref))
    assert share.max() < 0.5


def test_k2_tf32_operands_cut_the_rounding_error():
    """tf32 att and state operands (the serve kernel's) err less than bf16
    ones against the exact f32 oracle (root mean square: the maximum of one
    small draw is noisy), and both stay in tolerance of it."""
    arrays = _ssd_inputs(1, 512, 4, 1, 64, 128, seed=11, serve=True)
    ref = np.asarray(jax.jit(ssd_ref)(*(jnp.asarray(a) for a in arrays))[0])
    err = {}
    for name, operand in (("bf16", _bf16), ("tf32", _tf32)):
        y, _ = k2_tc_model(*(torch.from_numpy(a) for a in arrays), operand=operand)
        np.testing.assert_allclose(y.numpy(), ref, atol=5e-2, rtol=5e-2)
        err[name] = np.sqrt(np.mean((y.numpy() - ref) ** 2))
    assert err["tf32"] < 0.75 * err["bf16"], err


K2_WG_CASES = [   # name, (B, S, H, G, P, N), regime, h0: ragged S, G > 1, P and N 64 / 128
    ("ragged_grouped_h0", (2, 333, 4, 2, 64, 64), "test", True),
    ("serve_regime", (1, 512, 4, 1, 64, 128), "serve", False),
    ("train_regime_h0", (1, 400, 2, 1, 128, 128), "train", True),
    ("ragged_grouped_p128_n64", (1, 300, 4, 2, 128, 64), "test", False),
]
WG_SEGMENTS = (1, 2, 3, 5)


def _wg_case(name, shape, regime, with_h0):
    B, S, H, G, P, N = shape
    arrays = _ssd_inputs(*shape, seed=sum(map(ord, name)), serve=regime == "serve",
                         train=regime == "train")
    h0 = (np.random.default_rng(len(name)).standard_normal((B, H, P, N)) * 0.5).astype(
        np.float32) if with_h0 else None
    if regime == "train":      # the chunks decay as a train microbatch's largest
        dt, A = arrays[1], arrays[2]
        decay = (dt * -A[None, :, None])[:, :, :S // CHUNK * CHUNK].reshape(
            B, H, -1, CHUNK).sum(-1)
        assert decay.max() > 80
    return arrays, h0


def _wg_model(arrays, h0, **kw):
    return k2_wg_model(*(torch.from_numpy(a) for a in arrays),
                       h0=None if h0 is None else torch.from_numpy(h0), **kw)


@pytest.mark.parametrize("segments", WG_SEGMENTS)
@pytest.mark.parametrize("name,shape,regime,with_h0", K2_WG_CASES,
                         ids=[c[0] for c in K2_WG_CASES])
def test_k2_wg_rounding_within_tolerance_of_jax_ref(name, shape, regime, with_h0, segments):
    arrays, h0 = _wg_case(name, shape, regime, with_h0)
    y, st = _wg_model(arrays, h0, segments=segments)
    yr, sr = ssd_ref(*_jax_args(*arrays), h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(_bf16(y).numpy(), np.asarray(yr, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=5e-2, rtol=5e-2)
    assert np.isfinite(y.numpy()).all() and np.isfinite(st.numpy()).all()


@pytest.mark.parametrize("segments", WG_SEGMENTS)
@pytest.mark.parametrize("name,shape,regime,with_h0", K2_WG_CASES,
                         ids=[c[0] for c in K2_WG_CASES])
def test_k2_wg_split_is_exact_at_f32_operands(name, shape, regime, with_h0, segments):
    """With no operand rounding the three-phase split is the same function
    as the step-by-step recurrence: within 1e-4 of ``ssd_ref`` on the same
    (bf16-valued) f32 inputs."""
    arrays, h0 = _wg_case(name, shape, regime, with_h0)
    y, st = _wg_model(arrays, h0, segments=segments, operand=lambda a: a)
    yr, sr = ssd_ref(*(jnp.asarray(a) for a in arrays),
                     h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,shape,regime,segments", [
    ("serve_regime", (1, 512, 4, 1, 64, 128), "serve", 3),
    ("ragged_grouped_p128_n64", (1, 300, 4, 2, 128, 64), "test", 2),
], ids=["serve_regime", "ragged_grouped_p128_n64"])
def test_k2_wg_rounding_within_tolerance_of_pallas_interpret(name, shape, regime, segments):
    arrays, _ = _wg_case(name, shape, regime, False)
    y, st = _wg_model(arrays, None, segments=segments)
    yr, sr = pallas_ssd(*_jax_args(*arrays), chunk=64, interpret=True)
    np.testing.assert_allclose(_bf16(y).numpy(), np.asarray(yr, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=5e-2, rtol=5e-2)


def test_k2_wg_split_operands_cut_the_rounding_error():
    """hi + lo operands err far less than the "tc" kernel's (tf32 att and
    state, bf16 B .* w) against the exact f32 oracle, at the serve regime."""
    arrays = _ssd_inputs(1, 512, 4, 1, 64, 128, seed=11, serve=True)
    ref = np.asarray(jax.jit(ssd_ref)(*(jnp.asarray(a) for a in arrays))[0])
    tc, _ = k2_tc_model(*(torch.from_numpy(a) for a in arrays), operand=_tf32)
    wg, _ = k2_wg_model(*(torch.from_numpy(a) for a in arrays), segments=2)
    rms = {k: np.sqrt(np.mean((v.numpy() - ref) ** 2)) for k, v in (("tc", tc), ("wg", wg))}
    assert rms["wg"] < 0.1 * rms["tc"], rms


def test_k2_wg_att_needs_its_lo_half_at_the_train_regime():
    """Where chunks decay by ~87 (a train microbatch's largest), the hi + lo
    operands use under 1% of the tolerance against the exact f32 oracle,
    while att alone rounded to bf16 would use over a quarter of it: why
    "wg" splits att as well as the state and x .* w."""
    arrays, _ = _wg_case("train_regime_h0", (1, 1024, 8, 1, 64, 128), "train", False)
    ref = np.asarray(jax.jit(ssd_ref)(*(jnp.asarray(a) for a in arrays))[0])
    share = {}
    for name, att in (("split", None), ("bf16", _bf16)):
        y, _ = _wg_model(arrays, None, segments=2, att_operand=att)
        share[name] = (np.abs(y.numpy() - ref) / (5e-2 + 5e-2 * np.abs(ref))).max()
    assert share["split"] < 0.01 and share["bf16"] > 0.25, share
