"""The port's accelerator statistics backend (``backend="torch"``,
``kernels/stats_boot.py``) against the NumPy path and against the JAX
package's ``backend="jax"``, on the CPU.

Both accelerator backends bootstrap the NumPy path's resamples in float32,
so they agree with it to float tolerance: rtol 1e-5 / atol 1e-6, as in
tests/test_stats_batch.py.
"""
import numpy as np
import pytest

from repro.core import stats as jax_stats
from repro_torch.core import stats
from repro_torch.kernels import stats_boot

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, equal_nan=True, **TOL)


def _torch(arrays, **kw):
    return stats.bootstrap_median_ci_batch(arrays, backend="torch", device="cpu", **kw)


def test_torch_backend_agrees_with_numpy_and_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(0, 1, n) for n in (45, 45, 128, 31, 10)]
    got = _torch(arrays, seed=3)
    _close(got, stats.bootstrap_median_ci_batch(arrays, seed=3))
    _close(got, jax_stats.bootstrap_median_ci_batch(arrays, seed=3, backend="jax"))


@pytest.mark.parametrize("confidence, n_boot", [(0.95, 500), (0.99, 2000)])
def test_torch_backend_agrees_at_other_budgets(confidence, n_boot):
    rng = np.random.default_rng(1)
    arrays = [rng.lognormal(0.0, 0.05, n) - 1.0 for n in (45, 45, 45, 12, 60, 0)]
    kw = dict(confidence=confidence, n_boot=n_boot, seed=7)
    got = _torch(arrays, **kw)
    assert np.isnan(got[0][-1]) and np.isfinite(got[0][:-1]).all()
    _close(got, stats.bootstrap_median_ci_batch(arrays, **kw))
    _close(got, jax_stats.bootstrap_median_ci_batch(arrays, backend="jax", **kw))


def test_even_length_median_is_the_mean_of_the_two_middles():
    x = np.array([0.0, 1.0, 3.0, 10.0])             # middles 1 and 3: median 2
    torch = pytest.importorskip("torch")
    assert torch.median(torch.tensor(x)).item() == 1.0     # the lower middle
    med, lo, hi = _torch([x, x[:3]], seed=0)
    assert med.tolist() == [2.0, 1.0]
    _close((med, lo, hi), stats.bootstrap_median_ci_batch([x, x[:3]], seed=0))


def test_non_finite_rows_give_the_numpy_result():
    rng = np.random.default_rng(2)
    arrays = [rng.normal(0, 1, 20) for _ in range(4)]
    arrays[1][3] = np.nan
    arrays[2][0] = np.inf
    got = _torch(arrays, seed=5)
    ref = stats.bootstrap_median_ci_batch(arrays, seed=5)
    for i in (1, 2):     # deferred to the scalar NumPy path: bit for bit
        assert repr([g[i] for g in got]) == repr([r[i] for r in ref])
    assert np.isnan([g[1] for g in got]).all()
    _close(got, ref)


def test_a_forced_small_chunk_equals_one_chunk(monkeypatch):
    rng = np.random.default_rng(3)
    arrays = [rng.normal(0.02, 0.05, 45) for _ in range(37)]
    whole = _torch(arrays, seed=1)
    monkeypatch.setattr(stats_boot, "_GATHER_BYTES", 5 * 1000 * 45 * 4)   # 5 rows a chunk
    chunked = _torch(arrays, seed=1)
    for a, b in zip(whole, chunked):
        assert a.tolist() == b.tolist()


def test_detect_changes_batch_through_the_torch_backend():
    rng = np.random.default_rng(4)
    items = [(f"b{i}", rng.lognormal(0.0, 0.03, 30), rng.lognormal(0.05 * (i % 2), 0.03, 30))
             for i in range(6)]
    got = stats.detect_changes_batch(items, seed=2, backend="torch", device="cpu")
    ref = stats.detect_changes_batch(items, seed=2)
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].changed == ref[name].changed
        np.testing.assert_allclose([got[name].ci_low, got[name].ci_high],
                                   [ref[name].ci_low, ref[name].ci_high], **TOL)


@pytest.mark.parametrize("backend", ["jax", "cuda"])
def test_unknown_backends_raise(backend):
    with pytest.raises(ValueError, match=f"unknown stats backend '{backend}'"):
        stats.bootstrap_median_ci_batch([np.ones(12)], backend=backend)


def test_the_card_is_required_unless_the_cpu_is_asked_for():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        stats.bootstrap_median_ci_batch([np.ones(12)], backend="torch")
