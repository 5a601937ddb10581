"""The port's kernel-duet suite behind its registry: the twin of
tests/test_cb_kernel_suite.py, plus the duets held against the JAX suite's
functions on the same numpy inputs, at the JAX tests' tolerances
(attention 1e-5, tests/test_attention.py:28; SSD 1e-4, tests/test_ssm.py:32;
rms_norm 1e-5).  Everything here runs on the CPU (``device="cpu"``), where
``ssd_chunked`` is K2's plain version; the card runs the same suite in
tests/test_torch_card_paths.py."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models.attention import attention_chunked, attention_dot  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.benchmarks import kernel_bench  # noqa: E402
from repro_torch.cb import (Pipeline, PipelineConfig, available_suites,  # noqa: E402
                            get_suite)
from repro_torch.cb.history import SOURCE_RUN  # noqa: E402

SSD = "ssd_recurrence_vs_chunked"


def test_kernel_suite_is_registered():
    assert "kernels" in available_suites()
    suite = get_suite("kernels", small=True, device="cpu")
    assert suite.benchmark_names() == sorted(kernel_bench._FP_MODULES)
    assert suite.benchmark_names() == ["attention_dot_vs_chunked",
                                       "rmsnorm_fused_vs_unfused", SSD]
    assert suite.device == torch.device("cpu")
    assert sorted(kernel_bench.make_duets(small=True, device="cpu")) == suite.benchmark_names()


def test_kernel_fingerprints_track_sources():
    fps = kernel_bench.kernel_fingerprints()
    assert set(fps) == set(kernel_bench._FP_MODULES)
    assert fps == kernel_bench.kernel_fingerprints()    # stable
    assert len(set(fps.values())) == len(fps)           # per-benchmark


@pytest.mark.parametrize("module,bench", [
    ("repro_torch.models.attention", "attention_dot_vs_chunked"),
    ("repro_torch.kernels.ref", SSD),
    ("repro_torch.models.ssm", SSD),
    ("repro_torch.kernels.ssd_scan", SSD),
    ("repro_torch.models.layers", "rmsnorm_fused_vs_unfused"),
])
def test_editing_a_covered_module_changes_only_its_benchmark(monkeypatch, module, bench):
    before = kernel_bench.kernel_fingerprints()
    real = kernel_bench._module_source
    monkeypatch.setattr(kernel_bench, "_module_source",
                        lambda name: real(name) + ("\n# edited" if name == module else ""))
    after = kernel_bench.kernel_fingerprints()
    assert [b for b in before if before[b] != after[b]] == [bench]


@pytest.mark.parametrize("source", ["ssd_scan.cu", "tc_common.cuh"])
def test_editing_k2_cuda_source_changes_the_ssd_fingerprint(monkeypatch, tmp_path, source):
    """On the card ssd_chunked is K2, so its CUDA source and the shared
    headers are part of what the SSD duet measures."""
    before = kernel_bench.kernel_fingerprints()
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_bench.CSRC, csrc)
    monkeypatch.setattr(kernel_bench, "CSRC", csrc)
    assert kernel_bench.kernel_fingerprints() == before
    (csrc / source).write_text((csrc / source).read_text() + "\n// edited\n")
    after = kernel_bench.kernel_fingerprints()
    assert [b for b in before if before[b] != after[b]] == [SSD]
    (csrc / "flash_attention.cu").write_text("// K1 is on no duet's path\n")
    assert kernel_bench.kernel_fingerprints() == after
    (csrc / "ssd_scan.cu").unlink()
    with pytest.raises(FileNotFoundError, match="ssd_scan.cu"):
        kernel_bench.kernel_fingerprints()


def test_kernel_commits_change_every_benchmark():
    base, head = kernel_bench.kernel_commits()
    assert base.index == 0 and head.parent == base.commit_id
    for b in base.fingerprints:
        assert base.fingerprints[b] != head.fingerprints[b]


def test_pipeline_runs_real_kernels_end_to_end():
    commits = kernel_bench.kernel_commits()
    cfg = PipelineConfig(suite="kernels", provider="local", mode="selective",
                         n_calls=5, repeats_per_call=1, parallelism=1,
                         min_results=4)
    pipe = Pipeline(get_suite("kernels", small=True, device="cpu"), cfg)
    rep = pipe.run_stream(commits)
    run = rep.commits[0]
    assert set(run.ran) == set(kernel_bench._FP_MODULES)
    assert run.invocations == 5 * len(run.ran)
    # real timings flowed through engine -> analysis -> history
    assert all(c.n_pairs == 5 for c in run.changes.values())
    recs = [r for r in pipe.history.records() if r.source == SOURCE_RUN]
    assert len(recs) == len(run.ran)
    assert all(r.invocations == 5 and r.billed_seconds > 0 for r in recs)


def test_parallelism_is_capped_by_device(monkeypatch):
    """Two duets on one GPU would contend: parallelism 1 on the card, 2 on
    the CPU, whatever the caller asks for."""
    seen = []
    monkeypatch.setattr(kernel_bench, "run_plan",
                        lambda backend, plan, **kw: seen.append(kw["parallelism"]))
    suite = kernel_bench.KernelSuite(small=True, device="cpu")
    suite._duets = dict.fromkeys(suite.benchmark_names())
    commit = kernel_bench.kernel_commits()[1]
    suite.run(suite.benchmark_names(), commit, parallelism=8)
    suite.device = torch.device("cuda")
    suite.run(suite.benchmark_names(), commit, parallelism=8)
    suite.run(suite.benchmark_names(), commit, parallelism=0)
    assert seen == [2, 1, 1]
    with pytest.raises(ValueError, match="fault injection"):
        suite.run(suite.benchmark_names(), commit, chaos=object())


def test_table_kernel_duets_on_the_cpu(monkeypatch):
    small = kernel_bench.make_duets
    monkeypatch.setattr(kernel_bench, "make_duets",
                        lambda device: small(small=True, device=device))
    name, harness_us, rows = kernel_bench.table_kernel_duets(device="cpu")
    assert name == "kernel_duets_real" and harness_us > 0
    assert rows["invocations"] == 36
    assert all(rows[b]["n"] == 12 for b in kernel_bench._FP_MODULES)


# ------------------------------------------------ duets against the JAX suite
def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(a_torch, b, tol):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a_torch.detach().numpy(), b, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [dict(S=64), dict()])      # small, default
def test_attention_duet_matches_jax(shape):
    B, S, H, hd = 1, shape.get("S", 256), 4, 64
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    v1, v2 = kernel_bench.attention_v1(*_t(q, k, v)), kernel_bench.attention_v2(*_t(q, k, v))
    _close(v1, attention_dot(*_j(q, k, v), causal=True), 1e-5)
    _close(v2, attention_chunked(*_j(q, k, v), causal=True, chunk=64), 1e-5)
    _close(v1, v2, 1e-5)


def _ssd_numpy(B=1, S=512, H=4, P=32, N=32, seed=1):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(r.standard_normal((B, S, H)), 0.0).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.5)).astype(np.float32)
    Bi = (r.standard_normal((B, S, 1, N)) * 0.5).astype(np.float32)
    Ci = (r.standard_normal((B, S, 1, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bi, Ci


@pytest.mark.parametrize("shape", [dict(S=128, P=16, N=16), dict()])
def test_ssd_duet_matches_jax(shape):
    x, dt, A, Bi, Ci = _ssd_numpy(**shape)
    v1 = kernel_bench.ssd_v1(*_t(x, dt, A, Bi, Ci))         # head-major, as in JAX
    v2 = kernel_bench.ssd_v2(*_t(x, dt, A, Bi, Ci))
    jx, jdt, jA, jB, jC = _j(x, dt, A, Bi, Ci)
    ref1 = jax_ssd_ref(jnp.moveaxis(jx, 1, 2), jnp.moveaxis(jdt, 1, 2), jA,
                       jnp.moveaxis(jB, 1, 2), jnp.moveaxis(jC, 1, 2))[0]
    ref2 = jax_ssd_chunked(jx, jdt, jA, jB, jC, chunk=64)[0]
    assert v1.shape == (1, 4, x.shape[1], x.shape[3]) and v2.shape == x.shape
    _close(v1, ref1, 1e-4)
    _close(v2, ref2, 1e-4)
    _close(v1.movedim(1, 2), v2, 1e-4)


@pytest.mark.parametrize("T,D", [(512, 128), (4096, 512)])
def test_rmsnorm_duet_matches_jax(T, D):
    r = np.random.default_rng(2)
    x = r.standard_normal((T, D)).astype(np.float32)
    w = (0.1 * r.standard_normal(D)).astype(np.float32)
    jx, jw = _j(x, w)
    unfused = (jx / jnp.sqrt(jnp.mean(jx * jx, -1, keepdims=True) + 1e-6)) * (1 + jw)
    v1, v2 = kernel_bench.rmsnorm_v1(*_t(x, w)), kernel_bench.rmsnorm_v2(*_t(x, w))
    _close(v1, unfused, 1e-5)
    _close(v2, jax_rms_norm(jx, jw, 1e-6), 1e-5)
    _close(v1, v2, 1e-5)


def test_input_draws_are_seeded_and_on_the_asked_device():
    shapes = {kernel_bench.attention_inputs: [(1, 256, 4, 64)] * 3,
              kernel_bench.ssd_inputs: [(1, 512, 4, 32), (1, 512, 4), (4,),
                                        (1, 512, 1, 32), (1, 512, 1, 32)],
              kernel_bench.rmsnorm_inputs: [(4096, 512), (512,)]}
    for draw, want in shapes.items():
        a, b = draw(device="cpu"), draw(device="cpu")
        assert [tuple(t.shape) for t in a] == want
        assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in a)
        assert all(torch.equal(s, t) for s, t in zip(a, b))
    x, dt, A, *_ = kernel_bench.ssd_inputs(device="cpu")
    assert (dt > 0).all() and (A < 0).all()
