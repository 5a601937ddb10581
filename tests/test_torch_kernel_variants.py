"""Which kernel variant a K1 or K2 call takes, and when the libraries rebuild.

bf16 calls that the tensor-core kernels can take go to them: K1 at head dim
64 or 128 to its wgmma kernel ("wg"), at any other multiple of 16 to its
mma.sync kernel ("tc"); K2 at P and N of 64 or 128 to "wg" (split over the
sequence in ``k2_segments`` segments), at the other multiples of 8 to "tc".
Every other call goes to the fp32 CUDA-core kernels ("fma").  The choice is made in Python, so it is tested
here without a card; the kernels themselves are tested on the card by
tests/test_torch_kernels_card.py.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.all_configs import ARCH_IDS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,variant", [
    (BF16, 128, "wg"), (BF16, 64, "wg"), (BF16, 256, "tc"), (BF16, 16, "tc"),
    (BF16, 96, "tc"),              # a multiple of 16 that is not a power of two
    (BF16, 72, "fma"), (BF16, 100, "fma"), (BF16, 8, "fma"),
    (BF16, 272, "fma"),            # past the largest head dim either kernel takes
    (F32, 128, "fma"), (F32, 64, "fma"), (F32, 256, "fma"),
    (BF16, 32, "tc"),              # the reduced() configs and Jamba's phase 11 run
    (BF16, 192, "tc"),             # wg takes only the serve paths' head dims
    (F32, 16, "fma"), (F32, 96, "fma"),
])
def test_k1_variant(dtype, hd, variant):
    assert fa.k1_variant(dtype, hd) == variant


@pytest.mark.parametrize("dtype,P,N,variant", [
    (BF16, 64, 128, "wg"),         # mamba2-1.3b
    (BF16, 128, 128, "wg"),        # jamba's Mamba layers
    (BF16, 64, 64, "wg"),
    (BF16, 96, 128, "tc"),         # wg takes P and N of 64 and 128 only
    (BF16, 16, 16, "tc"), (BF16, 32, 64, "tc"), (BF16, 8, 8, "tc"),
    (BF16, 24, 16, "tc"),
    (BF16, 20, 16, "fma"), (BF16, 64, 12, "fma"),   # rows not 16-byte multiples
    (BF16, 136, 128, "fma"), (BF16, 64, 256, "fma"),
    (F32, 64, 128, "fma"), (F32, 16, 16, "fma"),
])
def test_k2_variant(dtype, P, N, variant):
    assert ks.k2_variant(dtype, P, N) == variant


def test_every_config_serves_bf16_on_the_tensor_cores():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.head_dim:
            want = "wg" if cfg.head_dim in (64, 128) else "tc"     # gemma3's 256 on tc
            assert fa.k1_variant(BF16, cfg.head_dim) == want, arch
        if cfg.ssm is not None:
            assert ks.k2_variant(BF16, cfg.ssm.head_dim, cfg.ssm.d_state) == "wg", arch
    assert {a for a in ARCH_IDS if get_config(a).ssm is not None} == {
        "mamba2-1.3b", "jamba-1.5-large-398b"}


SM_COUNT = 132      # an H100 SXM


@pytest.mark.parametrize("B,S,H,P,want", [
    (1, 32768, 64, 64, 4),         # the mamba2-1.3b prefill_32k cell: 256 blocks
    (2, 4096, 64, 64, 2),          # a mamba2-1.3b train microbatch: 256 blocks
    (4, 1024, 64, 64, 1),          # the mamba2-1.3b serve prefill: 256 blocks
    (4, 1024, 128, 128, 1),        # the jamba mixer: 512 blocks, one a SM
    (4, 255, 64, 64, 1), (1, 64, 4, 64, 1), (1, 1, 2, 128, 1),   # S < 256
    (1, 448, 2, 64, 1),            # 7 chunks: too short for two segments of 4
    (1, 512, 2, 64, 2),            # 8 chunks: two segments of 4
    (1, 100_000, 2, 64, 132),      # one wave of 264 slots
])
def test_k2_segments_rule(B, S, H, P, want):
    """Whole chunks of at least 4 (one segment below 512 positions), and as
    many segments as the block slots take in one wave."""
    n = ks.k2_segments(B, H, S, SM_COUNT, ks.WG_BLOCKS_PER_SM[P])
    assert n == want
    chunks = -(-S // 64)
    slots = SM_COUNT * ks.WG_BLOCKS_PER_SM[P]
    assert B * H * n <= max(slots, B * H)                 # one wave
    if n > 1:
        assert chunks // n >= ks.WG_MIN_CHUNKS             # segment s: chunks [s nc / n, (s+1) nc / n)
        assert B * H * (n + 1) > slots or chunks // (n + 1) < ks.WG_MIN_CHUNKS   # the most that fit
    assert ks.k2_segments(B, H, S, SM_COUNT, ks.WG_BLOCKS_PER_SM[P]) == n   # a pure function


_K1_KW = dict(causal=True, window=0, kv_valid=None, softmax_scale=None)


def test_k1_refuses_a_variant_that_cannot_take_the_call():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="variant"):
        fa._launch(q, q, q, "tc", **_K1_KW)                       # f32
    qb = torch.zeros(1, 2, 8, 72, dtype=BF16)
    with pytest.raises(ValueError, match="variant"):
        fa._launch(qb, qb, qb, "tc", **_K1_KW)                    # hd 72
    with pytest.raises(ValueError, match="variant"):
        fa._launch(qb, qb, qb, "wgmma", **_K1_KW)
    with pytest.raises(ValueError, match="device"):               # a valid variant, on the CPU
        fa._launch(qb, qb, qb, "fma", **_K1_KW)
    for dtype, hd in [(F32, 128), (F32, 64), (BF16, 96), (BF16, 256), (BF16, 16)]:
        qw = torch.zeros(1, 2, 8, hd, dtype=dtype)
        with pytest.raises(ValueError, match="variant"):           # wg: bf16 at hd 64 / 128 only
            fa._launch(qw, qw, qw, "wg", **_K1_KW)
    with pytest.raises(ValueError, match="variant"):
        fa._launch(qb, qb, qb, "wg", **_K1_KW)                    # hd 72


@pytest.mark.parametrize("hd", [64, 128])
def test_k1_tc_stays_callable_where_wg_serves(hd):
    """At the head dims "wg" takes, "tc" is still a variant that takes the
    call (tests/test_torch_kernels_card.py holds it there), so on the CPU it
    gets as far as the device check."""
    qb = torch.zeros(1, 2, 8, hd, dtype=BF16)
    assert fa.k1_variant(BF16, hd) == "wg"
    for variant in ("tc", "fma"):
        with pytest.raises(ValueError, match="device"):
            fa._launch(qb, qb, qb, variant, **_K1_KW)
    with pytest.raises(ValueError, match="device"):
        fa._launch(qb, qb, qb, "wg", **_K1_KW)


def test_k2_refuses_a_variant_that_cannot_take_the_call():
    x, dt, A = torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8), -torch.ones(2)
    Bi = torch.zeros(1, 1, 8, 16)
    xb, Bb = x.to(BF16), Bi.to(BF16)
    with pytest.raises(ValueError, match="variant"):
        ks._launch(x, dt, A, Bi, Bi, None, "tc", F32)                # f32
    with pytest.raises(ValueError, match="variant"):
        ks._launch(xb, dt, A, Bb, Bb, None, "mma", BF16)
    with pytest.raises(ValueError, match="y in"):                   # only tc writes f32 y from bf16
        ks._launch(xb, dt, A, Bb, Bb, None, "fma", F32)
    with pytest.raises(ValueError, match="y in"):
        ks._launch(x, dt, A, Bi, Bi, None, "fma", BF16)
    with pytest.raises(ValueError, match="device"):                 # valid, on the CPU
        ks._launch(xb, dt, A, Bb, Bb, None, "tc", F32)
    with pytest.raises(ValueError, match="segments"):               # tc takes no segments
        ks._launch(xb, dt, A, Bb, Bb, None, "tc", BF16, segments=1)
    for dtype, P, N in [(F32, 64, 128), (BF16, 16, 16), (BF16, 96, 128), (BF16, 64, 32)]:
        xw = torch.zeros(1, 2, 8, P, dtype=dtype)                   # wg: bf16 at P, N 64 / 128
        Bw = torch.zeros(1, 1, 8, N, dtype=dtype)
        with pytest.raises(ValueError, match="variant"):
            ks._launch(xw, dt, A, Bw, Bw, None, "wg", dtype)
    xw = torch.zeros(1, 2, 300, 64, dtype=BF16)                     # 5 chunks of 64
    dw, Bw = torch.zeros(1, 2, 300), torch.zeros(1, 1, 300, 128, dtype=BF16)
    with pytest.raises(ValueError, match="y in"):
        ks._launch(xw, dw, A, Bw, Bw, None, "wg", F32)
    for segments in (0, 6):
        with pytest.raises(ValueError, match="segments"):
            ks._launch(xw, dw, A, Bw, Bw, None, "wg", BF16, segments=segments)
    for segments in (None, 1, 5):
        with pytest.raises(ValueError, match="device"):             # valid, on the CPU
            ks._launch(xw, dw, A, Bw, Bw, None, "wg", BF16, segments=segments)
    with pytest.raises(ValueError, match="device"):                 # tc where wg serves
        ks._launch(xw, dw, A, Bw, Bw, None, "tc", BF16)


def test_cpu_calls_count_no_variant():
    fa.flash_attention_hmajor.launches_by_variant.update(wg=0, tc=0, fma=0)
    ks.ssd_scan_hmajor.launches_by_variant.update(wg=0, tc=0, fma=0)
    fa.flash_attention_hmajor(torch.zeros(1, 2, 8, 16, dtype=BF16),
                              torch.zeros(1, 2, 8, 16, dtype=BF16),
                              torch.zeros(1, 2, 8, 16, dtype=BF16))
    fa.flash_attention_hmajor(*(torch.zeros(1, 2, 8, 72, dtype=BF16),) * 3)   # hd 72 -> fma
    fa.flash_attention_hmajor(*(torch.zeros(1, 2, 8, 64, dtype=BF16),) * 3)   # hd 64 -> wg
    ks.ssd_scan_hmajor(torch.zeros(1, 2, 8, 16, dtype=BF16), torch.zeros(1, 2, 8),
                       -torch.ones(2), torch.zeros(1, 1, 8, 16, dtype=BF16),
                       torch.zeros(1, 1, 8, 16, dtype=BF16), chunk=4)
    ks.ssd_scan_hmajor(torch.zeros(1, 2, 8, 64, dtype=BF16), torch.zeros(1, 2, 8),   # wg
                       -torch.ones(2), torch.zeros(1, 1, 8, 128, dtype=BF16),
                       torch.zeros(1, 1, 8, 128, dtype=BF16), chunk=4)
    assert fa.flash_attention_hmajor.launches_by_variant == {"wg": 0, "tc": 0, "fma": 0}
    assert ks.ssd_scan_hmajor.launches_by_variant == {"wg": 0, "tc": 0, "fma": 0}


def _fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// helpers v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return csrc


@pytest.mark.parametrize("changed", ["header", "source", "new_header"])
def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch, changed):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    before = build.library_path("k")
    assert build.library_path("k") == before          # stable while nothing changes
    if changed == "header":
        (csrc / "common.cuh").write_text("// helpers v2\n")
    elif changed == "source":
        (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    else:
        (csrc / "more.cuh").write_text("// another shared header\n")
    after = build.library_path("k")
    assert after != before
    assert after.parent == tmp_path / "out" and after.name.startswith("libk-")


def test_library_name_ignores_other_files(tmp_path, monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    before = build.library_path("k")
    (csrc / "notes.txt").write_text("not compiled\n")
    (csrc / "other.cu").write_text("// another library's source\n")
    assert build.library_path("k") == before
