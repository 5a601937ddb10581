"""Which kernel variant a K1 or K2 call takes, and when the libraries rebuild.

bf16 calls that the tensor-core kernels can take go to them ("tc"); every
other call goes to the fp32 CUDA-core kernels ("fma").  The choice is made
in Python, so it is tested here without a card; the kernels themselves are
tested on the card by tests/test_torch_kernels_card.py.
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
    (BF16, 128, "tc"), (BF16, 64, "tc"), (BF16, 256, "tc"), (BF16, 16, "tc"),
    (BF16, 96, "tc"),              # a multiple of 16 that is not a power of two
    (BF16, 72, "fma"), (BF16, 100, "fma"), (BF16, 8, "fma"),
    (BF16, 272, "fma"),            # past the largest head dim either kernel takes
    (F32, 128, "fma"), (F32, 64, "fma"), (F32, 256, "fma"),
])
def test_k1_variant(dtype, hd, variant):
    assert fa.k1_variant(dtype, hd) == variant


@pytest.mark.parametrize("dtype,P,N,variant", [
    (BF16, 64, 128, "tc"),         # mamba2-1.3b
    (BF16, 128, 128, "tc"),        # jamba's Mamba layers
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
            assert fa.k1_variant(BF16, cfg.head_dim) == "tc", arch
        if cfg.ssm is not None:
            assert ks.k2_variant(BF16, cfg.ssm.head_dim, cfg.ssm.d_state) == "tc", arch


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


def test_cpu_calls_count_no_variant():
    fa.flash_attention_hmajor.launches_by_variant.update(tc=0, fma=0)
    ks.ssd_scan_hmajor.launches_by_variant.update(tc=0, fma=0)
    fa.flash_attention_hmajor(torch.zeros(1, 2, 8, 16, dtype=BF16),
                              torch.zeros(1, 2, 8, 16, dtype=BF16),
                              torch.zeros(1, 2, 8, 16, dtype=BF16))
    fa.flash_attention_hmajor(*(torch.zeros(1, 2, 8, 72, dtype=BF16),) * 3)   # hd 72 -> fma
    ks.ssd_scan_hmajor(torch.zeros(1, 2, 8, 16, dtype=BF16), torch.zeros(1, 2, 8),
                       -torch.ones(2), torch.zeros(1, 1, 8, 16, dtype=BF16),
                       torch.zeros(1, 1, 8, 16, dtype=BF16), chunk=4)
    assert fa.flash_attention_hmajor.launches_by_variant == {"tc": 0, "fma": 0}
    assert ks.ssd_scan_hmajor.launches_by_variant == {"tc": 0, "fma": 0}


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
