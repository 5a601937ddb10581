"""The port's copies of the NumPy analysis layers against the JAX package's:
RMIT plans, synthetic commit streams, the bootstrap CI, batched change
detection and ``analyze``.  Both sides are the same NumPy code, so every
result must agree bit for bit (floats compared by their exact repr)."""
import json
from dataclasses import asdict

import numpy as np
import pytest

from repro.cb import commits as jax_commits
from repro.core import results as jax_results
from repro.core import rmit as jax_rmit
from repro.core import stats as jax_stats
from repro.core.duet import DuetPair as JaxDuetPair
from repro_torch.cb import commits
from repro_torch.core import results, rmit, stats
from repro_torch.core.duet import DuetPair


def canon(obj):
    """Exact, class-blind text of a nest of dataclasses, dicts, lists and
    floats: two results are bit-identical iff their texts are equal."""
    if hasattr(obj, "__dataclass_fields__"):
        obj = asdict(obj)
    return json.dumps(obj, sort_keys=True, default=repr)


@pytest.mark.parametrize("kw", [
    dict(n_calls=15, repeats_per_call=3, seed=0),
    dict(n_calls=12, repeats_per_call=1, seed=3),
    dict(n_calls=7, repeats_per_call=2, seed=11, randomize_order=False),
    dict(n_calls=5, repeats_per_call=4, seed=5, randomize_versions=False, timeout_s=7.5),
])
def test_make_plan_matches_jax(kw):
    names = [f"b{i:02d}" for i in range(9)]
    plan, ref = rmit.make_plan(names, **kw), jax_rmit.make_plan(names, **kw)
    assert len(plan.invocations) == 9 * kw["n_calls"]
    assert canon(plan) == canon(ref)
    tagged = rmit.tag_plan(plan, "job7")
    assert canon(tagged) == canon(jax_rmit.tag_plan(ref, "job7"))


@pytest.mark.parametrize("seed,start", [(0, 0), (4, 12), (9, 30)])
def test_extra_invocations_match_jax(seed, start):
    kw = dict(n_calls=6, repeats_per_call=3, start_call_index=start, seed=seed)
    got = rmit.extra_invocations("bench", **kw)
    ref = jax_rmit.extra_invocations("bench", **kw)
    assert len(got) == 6
    assert [canon(i) for i in got] == [canon(i) for i in ref]


@pytest.mark.parametrize("cfg", [
    dict(n_commits=12, touched_lo=2, touched_hi=5, drift_length=6,
         drift_per_commit_pct=2.0, seed=11),
    dict(n_commits=30, seed=0),
    dict(n_commits=8, touched_lo=1, touched_hi=3, p_effect=0.5, seed=4),
])
def test_synthetic_stream_matches_jax(cfg):
    names = [f"s{i:02d}" for i in range(14)]
    kw = dict(effectable=names[:13], drift_candidates=names[:6])
    got, drift = commits.synthetic_stream(names, commits.StreamConfig(**cfg), **kw)
    ref, ref_drift = jax_commits.synthetic_stream(
        names, jax_commits.StreamConfig(**cfg), **kw)
    assert len(got) == cfg["n_commits"]
    assert [canon(c) for c in got] == [canon(c) for c in ref]
    assert canon(drift) == canon(ref_drift)


def _diffs(rng, n, shift=0.0, outliers=0):
    x = rng.normal(shift, 3.0, n)
    if outliers:
        x[rng.choice(n, outliers, replace=False)] *= 40.0
    return x


@pytest.mark.parametrize("n,robust", [(1, "none"), (10, "none"), (37, "none"),
                                      (120, "none"), (45, "trim"), (45, "winsor")])
def test_bootstrap_median_ci_matches_jax(n, robust):
    x = _diffs(np.random.default_rng(n), n, shift=1.5, outliers=n // 15)
    kw = dict(n_boot=1000, seed=7, robust=robust)
    got = stats.bootstrap_median_ci(x, **kw)
    assert all(np.isfinite(got))
    assert canon(got) == canon(jax_stats.bootstrap_median_ci(x, **kw))


def test_bootstrap_median_ci_batch_matches_jax_on_ragged_input():
    rng = np.random.default_rng(0)
    arrays = [_diffs(rng, n, shift=s) for n, s in
              [(12, 0.0), (12, 4.0), (30, -2.0), (0, 0.0), (7, 1.0), (30, 0.5)]]
    arrays[4][2] = np.nan
    got = stats.bootstrap_median_ci_batch(arrays, n_boot=2000, seed=3)
    ref = jax_stats.bootstrap_median_ci_batch(arrays, n_boot=2000, seed=3)
    assert np.isnan(got[0][3]) and np.isfinite(got[0][0])
    assert canon([a.tolist() for a in got]) == canon([a.tolist() for a in ref])


def test_stats_has_only_the_numpy_backend():
    """"jax" stays an unknown backend in the port; "torch" (here on the CPU)
    agrees with NumPy at tests/test_stats_batch.py's tolerance."""
    with pytest.raises(ValueError, match="unknown stats backend 'jax'"):
        stats.bootstrap_median_ci_batch([np.ones(12)], backend="jax")
    with pytest.raises(ValueError, match="unknown stats backend 'jax'"):
        stats.detect_changes_batch([("b", np.ones(12), np.ones(12))], backend="jax")
    rng = np.random.default_rng(0)
    arrays = [rng.normal(0, 1, n) for n in (45, 45, 128, 31, 10)]
    got = stats.bootstrap_median_ci_batch(arrays, seed=3, backend="torch", device="cpu")
    for g, r in zip(got, stats.bootstrap_median_ci_batch(arrays, seed=3)):
        assert np.allclose(g, r, rtol=1e-5, atol=1e-6)


def _suite_timings(seed):
    rng = np.random.default_rng(seed)
    items = []
    for i, (n, effect) in enumerate([(15, 0.0), (15, 8.0), (9, -5.0), (40, 1.0),
                                     (4, 20.0), (25, -12.0)]):
        v1 = rng.lognormal(np.log(0.5 + 0.1 * i), 0.03, n)
        v2 = v1 * (1 + effect / 100) * rng.lognormal(0.0, 0.02, n)
        items.append((f"b{i}", v1, v2))
    return items


@pytest.mark.parametrize("seed,robust", [(0, "none"), (1, "none"), (2, "trim")])
def test_detect_changes_batch_matches_jax(seed, robust):
    items = _suite_timings(seed)
    kw = dict(n_boot=1500, seed=seed, min_results=8, robust=robust)
    got = stats.detect_changes_batch(items, **kw)
    ref = jax_stats.detect_changes_batch(items, **kw)
    assert list(got) == ["b0", "b1", "b2", "b3", "b5"]        # b4 has 4 < 8 pairs
    assert any(c.changed for c in got.values())
    assert canon(got) == canon(ref)
    for name, v1, v2 in items[:3]:
        one = stats.detect_change(name, v1, v2, **kw)
        assert canon(one) == canon(jax_stats.detect_change(name, v1, v2, **kw))


def _pairs(cls, seed):
    """Interleaved duet pairs of several benchmarks, as an engine returns them."""
    rng = np.random.default_rng(seed)
    out = []
    for call in range(20):
        for b, effect in (("attn", 6.0), ("norm", 0.0), ("ssd", -30.0)):
            if b == "norm" and call % 7 == 3:
                continue
            v1 = float(rng.lognormal(np.log(1e-3), 0.05))
            v2 = float(v1 * (1 + effect / 100) * rng.lognormal(0.0, 0.03))
            out.append(cls(benchmark=b, v1_seconds=v1, v2_seconds=v2,
                           instance_id=f"i{call % 3}", call_index=call,
                           cold_start=call == 0))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_analyze_and_streaming_analyzer_match_jax(seed):
    pairs, ref_pairs = _pairs(DuetPair, seed), _pairs(JaxDuetPair, seed)
    got = results.analyze(pairs, seed=seed, min_results=10)
    ref = jax_results.analyze(ref_pairs, seed=seed, min_results=10)
    assert list(got) == ["attn", "norm", "ssd"] and got["ssd"].direction == -1
    assert canon(got) == canon(ref)
    sa, ref_sa = results.StreamingAnalyzer(seed=seed), jax_results.StreamingAnalyzer(seed=seed)
    for p, q in zip(pairs, ref_pairs):
        sa.add_pair(p)
        ref_sa.add_pair(q)
    assert canon(sa.analyze()) == canon(ref_sa.analyze()) == canon(got)


def test_pairs_round_trip_through_each_others_jsonl(tmp_path):
    pairs = _pairs(DuetPair, 2)
    results.append_pairs(str(tmp_path / "port.jsonl"), pairs)
    jax_results.append_pairs(str(tmp_path / "jax.jsonl"), _pairs(JaxDuetPair, 2))
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    back = results.load_pairs(str(tmp_path / "jax.jsonl"))
    assert [canon(p) for p in back] == [canon(p) for p in pairs]
