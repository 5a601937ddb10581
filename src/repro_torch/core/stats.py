"""Statistical layer of ElastiBench (paper §2, §6.1).

Bootstrap confidence intervals of the *median relative performance
difference* between two SUT versions, change detection (99% CI excluding 0),
and the inter-experiment comparison measures from the paper: *agreement*
(same sign of detected change, or both no-change), *one-sided* and
*two-sided coverage* (CI containment of the other experiment's median).

All pure NumPy, deterministic given a seed.

Two equivalent execution paths share one resampling scheme:

  * scalar — `bootstrap_median_ci` / `detect_change`, one benchmark at a
    time (the historical seed API).
  * batched — `bootstrap_median_ci_batch` / `detect_changes_batch`, a whole
    suite in a few vectorized passes.  Per-benchmark diff arrays are
    grouped by length into 2D blocks; every benchmark of length ``n``
    shares one ``(n_boot, n)`` bootstrap index matrix, cached under
    ``(n, n_boot, seed)`` so repeated analyze calls and
    `repeats_for_ci_parity`'s prefix sweep stop re-drawing identical
    matrices.  Resample medians are extracted by counting draws in a
    narrow rank window around the sample median (exact; out-of-window rows
    fall back to a dense per-row median), which is several times cheaper
    than materializing and partitioning every resample.

Both paths produce bit-for-bit identical results for the same
``(confidence, n_boot, seed)``; the batched path is what the streaming
analyzer, adaptive controller, and cb pipeline run on.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

DEFAULT_CONFIDENCE = 0.99
DEFAULT_BOOTSTRAP = 1000

# bounded cache of bootstrap draws: ~2 MB per (n=200, n_boot=1000) entry.
# Sized for an adaptive run's sweep of pair counts (stop_min..max_results
# in repeats_per_call steps) so interim CI checks keep hitting.
_BOOT_CACHE_MAX = 64


@dataclass(frozen=True)
class ChangeResult:
    """Outcome of comparing v1/v2 timings of one microbenchmark."""
    benchmark: str
    n_pairs: int
    median_diff_pct: float          # median of per-pair relative diff, in %
    ci_low: float                   # CI of the median diff (pct)
    ci_high: float
    changed: bool                   # CI excludes 0
    direction: int                  # -1 faster, +1 slower, 0 no change

    @property
    def ci_size(self) -> float:
        return self.ci_high - self.ci_low


def relative_diffs(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Per-pair relative difference in % ((v2-v1)/v1*100).

    v1/v2 are paired duet timings from the same instance (paper §4): only
    the relative change within an instance is meaningful."""
    v1 = np.asarray(v1, dtype=np.float64)
    v2 = np.asarray(v2, dtype=np.float64)
    return (v2 - v1) / v1 * 100.0


class _BootDraw:
    """The cached resampling scheme for one (n, n_boot, seed): the index
    matrix the scalar path gathers with, plus (built lazily) the per-row
    draw-count histogram the batched counting method runs on."""

    __slots__ = ("idx", "_counts_t", "_counts_t_f32")

    def __init__(self, n: int, n_boot: int, seed: int):
        rng = np.random.default_rng(seed)
        self.idx = rng.integers(0, n, size=(n_boot, n))
        self.idx.setflags(write=False)
        self._counts_t: Optional[np.ndarray] = None
        self._counts_t_f32: Optional[np.ndarray] = None

    @property
    def counts_t(self) -> np.ndarray:
        """(n, n_boot) uint16, C-contiguous: how often resample row r drew
        original index i.  Index-major so that gathering a rank window
        copies whole contiguous rows instead of strided columns."""
        if self._counts_t is None:
            n_boot, n = self.idx.shape
            offs = self.idx + np.arange(n_boot, dtype=np.int64)[:, None] * n
            c = np.bincount(offs.ravel(), minlength=n_boot * n)
            # narrowest dtype whose range covers a full row's cumulative
            # sum (== n): the counting kernel is memory-bound, so uint8
            # halves the hot-loop traffic for every n <= 255 suite
            dt = (np.uint8 if n <= 255
                  else np.uint16 if n < 60_000 else np.uint32)
            self._counts_t = np.ascontiguousarray(c.reshape(n_boot, n).T
                                                  .astype(dt))
            self._counts_t.setflags(write=False)
        return self._counts_t

    @property
    def counts_t_f32(self) -> np.ndarray:
        """float32 view of `counts_t` for the BLAS below-window matmul
        (exact: integer counts < 2**24)."""
        if self._counts_t_f32 is None:
            self._counts_t_f32 = self.counts_t.astype(np.float32)
            self._counts_t_f32.setflags(write=False)
        return self._counts_t_f32


_boot_cache: "OrderedDict[tuple, _BootDraw]" = OrderedDict()


def _boot_draw(n: int, n_boot: int, seed: int) -> _BootDraw:
    key = (n, n_boot, seed)
    draw = _boot_cache.get(key)
    if draw is None:
        draw = _BootDraw(n, n_boot, seed)
        _boot_cache[key] = draw
        while len(_boot_cache) > _BOOT_CACHE_MAX:
            _boot_cache.popitem(last=False)
    else:
        _boot_cache.move_to_end(key)
    return draw


# ------------------------------------------------------------- robust path
# Contaminated samples (noisy-neighbor bursts, interference spikes — see
# faas/chaos.py) carry a fraction of wildly asymmetric diffs.  The
# bootstrap CI of the median is surprisingly sensitive to them: resample
# medians shift by the per-resample *count imbalance* of tail points, so
# a 20-30% contamination widens the CI enough to hide real 3-5% effects.
# The robust variants fence outliers with the standard MAD rule before
# resampling.  On outlier-free data (no point beyond the fence) both
# variants are exact identities — bit-for-bit the plain CI, which is the
# conformance contract the differential tests pin.

ROBUST_MODES = ("none", "trim", "winsor")
DEFAULT_ROBUST_K = 4.0


def robust_fences(x: np.ndarray, k: float = DEFAULT_ROBUST_K) -> tuple:
    """Outlier fences ``median +/- k * 1.4826 * MAD``.

    A zero MAD (half the sample tied) falls back to the IQR-based scale;
    if that is zero too, the fences are infinite (nothing is an outlier
    in a constant-ish sample)."""
    x = np.asarray(x, dtype=np.float64)
    med = np.median(x)
    scale = 1.4826 * float(np.median(np.abs(x - med)))
    if scale == 0.0:
        q1, q3 = np.percentile(x, [25.0, 75.0])
        scale = float(q3 - q1) / 1.349
    if scale == 0.0:
        return -math.inf, math.inf
    return float(med - k * scale), float(med + k * scale)


def winsorize_outliers(x: np.ndarray,
                       k: float = DEFAULT_ROBUST_K) -> np.ndarray:
    """Clip points beyond the MAD fences to the fence value (same n)."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) == 0 or not np.isfinite(x).all():
        return x                    # NaN/inf propagate like the plain path
    lo, hi = robust_fences(x, k)
    if np.all((x >= lo) & (x <= hi)):
        return x                    # outlier-free: exact identity
    return np.clip(x, lo, hi)


def trim_outliers(x: np.ndarray, k: float = DEFAULT_ROBUST_K) -> np.ndarray:
    """Drop points beyond the MAD fences (outlier-free input is returned
    unchanged, so the trimmed CI == the plain CI there)."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) == 0 or not np.isfinite(x).all():
        return x
    lo, hi = robust_fences(x, k)
    keep = (x >= lo) & (x <= hi)
    if keep.all():
        return x
    return x[keep]


def _robust_view(x: np.ndarray, robust: str,
                 k: float = DEFAULT_ROBUST_K) -> np.ndarray:
    if robust == "none":
        return np.asarray(x, dtype=np.float64)
    if robust == "trim":
        return trim_outliers(x, k)
    if robust == "winsor":
        return winsorize_outliers(x, k)
    raise ValueError(f"robust must be one of {ROBUST_MODES}, got {robust!r}")


def bootstrap_median_ci(x: np.ndarray, *, confidence: float = DEFAULT_CONFIDENCE,
                        n_boot: int = DEFAULT_BOOTSTRAP,
                        seed: int = 0, robust: str = "none",
                        robust_k: float = DEFAULT_ROBUST_K) -> tuple:
    """Percentile-bootstrap CI for the median of x.

    Empty input has no median: returns (nan, nan, nan) instead of raising
    from ``rng.integers(0, 0, ...)``.  ``robust="trim"``/``"winsor"``
    fence outliers first (see `robust_fences`); on outlier-free data the
    result is bit-for-bit the plain CI."""
    x = _robust_view(np.asarray(x, dtype=np.float64), robust, robust_k)
    n = len(x)
    if n == 0:
        return (float("nan"),) * 3
    alpha = (1.0 - confidence) / 2.0
    draw = _boot_draw(n, n_boot, seed)
    if not np.isfinite(x).all():
        # seed-exact NaN/inf propagation through np.median / np.quantile
        medians = np.median(x[draw.idx], axis=1)
        lo = np.quantile(medians, alpha, method="lower")
        hi = np.quantile(medians, 1.0 - alpha, method="higher")
        return float(np.median(x)), float(lo), float(hi)
    # same counting kernel as the batched path (k=1): bit-for-bit what
    # ``np.median(x[idx], axis=1)`` over a fresh draw produced, several
    # times cheaper — this is the adaptive controller's interim-check cost
    medians, xs = _window_medians_single(x, draw)
    lo_i, hi_i = _ci_order_stats(n_boot, alpha)
    medians.partition((lo_i, hi_i))
    lo, hi = medians[lo_i], medians[hi_i]
    k1, k2 = (n - 1) // 2, n // 2
    med = xs[k1] if k1 == k2 else (xs[k1] + xs[k2]) * 0.5  # == np.median(x)
    return float(med), float(lo), float(hi)


def detect_change(benchmark: str, v1: np.ndarray, v2: np.ndarray, *,
                  confidence: float = DEFAULT_CONFIDENCE,
                  n_boot: int = DEFAULT_BOOTSTRAP, seed: int = 0,
                  min_results: int = 10, robust: str = "none",
                  robust_k: float = DEFAULT_ROBUST_K
                  ) -> Optional[ChangeResult]:
    """Paper §6.1: benchmarks with fewer than `min_results` pairs are
    ignored (returns None); empty input is always None, whatever
    `min_results` says.  The `min_results` filter applies to the *raw*
    pair count — robust trimming never drops a benchmark from the
    analysis, it only refines its CI."""
    v1, v2 = np.asarray(v1), np.asarray(v2)
    n = min(len(v1), len(v2))
    if n == 0 or n < min_results:
        return None
    diffs = relative_diffs(v1[:n], v2[:n])
    med, lo, hi = bootstrap_median_ci(diffs, confidence=confidence,
                                      n_boot=n_boot, seed=seed,
                                      robust=robust, robust_k=robust_k)
    changed = lo > 0 or hi < 0
    direction = 0 if not changed else (1 if med > 0 else -1)
    return ChangeResult(benchmark=benchmark, n_pairs=n, median_diff_pct=med,
                        ci_low=lo, ci_high=hi, changed=changed,
                        direction=direction)


# ------------------------------------------------------------ batched path
# keep vectorized intermediates within ~CPU-cache-friendly sizes
_BATCH_CHUNK_ELEMS = 2_000_000


def _window_pad(n: int) -> int:
    """Rank-window half-width around the sample median: the draw count
    below a fixed rank is Binomial(n, p~0.5) with sd sqrt(n)/2, so 2*sqrt(n)
    is a z~4 window (miss odds ~6e-5 per resample row).  Rows whose
    crossing falls outside are recomputed exactly, so this only trades
    speed, never correctness."""
    return int(2.0 * math.sqrt(n)) + 2


def _ci_order_stats(n_boot: int, alpha: float) -> tuple:
    """0-based order-statistic positions of the conservative (outward) CI:
    exactly the elements ``np.quantile(..., alpha, method="lower")`` and
    ``np.quantile(..., 1-alpha, method="higher")`` select — same floor /
    ceil of the same float virtual index."""
    return (math.floor(alpha * (n_boot - 1)),
            math.ceil((1.0 - alpha) * (n_boot - 1)))


def _window_medians_single(x: np.ndarray, draw: _BootDraw, *,
                           pad: Optional[int] = None) -> tuple:
    """Dispatch-lean k=1 variant of `_window_medians` for the streaming /
    adaptive hot path (one interim CI check per delivered result).

    Returns ``(boot_medians, x_sorted)``; `boot_medians` is bit-for-bit
    ``np.median(x[draw.idx], axis=1)``.  `x` must be finite."""
    n = len(x)
    idx = draw.idx
    n_boot = idx.shape[0]
    k1, k2 = (n - 1) // 2, n // 2
    if pad is None:
        pad = _window_pad(n)
    L = max(0, k1 - pad)
    U = min(n, k2 + pad + 1)
    # tie order is irrelevant for the selected *values*, so the faster
    # default introsort is exact here
    order = np.argsort(x)
    xs = x[order]
    CT = draw.counts_t
    cw = CT[order[L:U]]                             # (U-L, n_boot) copy
    np.cumsum(cw, axis=0, out=cw)
    if L > 0:
        n_low = CT[order[:L]].sum(axis=0, dtype=np.int64)
        t1 = (k1 + 1) - n_low
        t2 = (k2 + 1) - n_low
        ok = (t1 >= 1) & (cw[-1] >= t2)             # int promotion is exact
        t1c = np.maximum(t1, 0).astype(CT.dtype)   # clamped rows fail `ok`
        t2c = np.maximum(t2, 0).astype(CT.dtype)
    else:
        t1c = CT.dtype.type(k1 + 1)
        t2c = CT.dtype.type(k2 + 1)
        ok = None if U == n else (cw[-1] >= t2c)
    j1 = L + np.count_nonzero(cw < t1c, axis=0)
    if k2 != k1:
        j2 = L + np.count_nonzero(cw < t2c, axis=0)
        med = (xs[j1] + xs[j2]) * 0.5               # == np.median's mean
    else:
        med = xs[j1]
    if ok is not None and not ok.all():
        rows = ~ok
        med[rows] = np.median(x[idx[rows]], axis=1)
    return med, xs


def _window_medians(block: np.ndarray, draw: _BootDraw, *,
                    pad: Optional[int] = None) -> tuple:
    """(k, n_boot) resample medians for k same-length benchmarks, sharing
    one cached draw — bit-for-bit equal to ``np.median(row[idx], axis=1)``
    per row — plus the (k,) sample medians (== ``np.median(row)``), which
    fall out of the sorted blocks for free.

    Method: the bootstrap-median of row r is the mean of the middle order
    statistic(s) of the resampled multiset, and the multiset is fully
    described by the shared per-row draw-count histogram.  Sorting each
    benchmark once, the crossing rank where cumulative counts reach n/2 is
    found inside a +-O(sqrt(n)) window around the sample median (the count
    below any fixed rank is Binomial, so a z~5 window misses ~1e-7 of
    rows); draws below the window are counted with one BLAS matmul against
    the shared histogram and the rare out-of-window rows are redone with a
    dense exact median.  Non-finite rows (inf/nan diffs) always take the
    dense path so NaN propagation matches ``np.median`` exactly.
    """
    k, n = block.shape
    idx = draw.idx
    n_boot = idx.shape[0]
    out = np.empty((k, n_boot))
    sample_med = np.empty(k)

    finite = np.isfinite(block).all(axis=1)
    for b in np.flatnonzero(~finite):
        out[b] = np.median(block[b][idx], axis=1)
        sample_med[b] = np.median(block[b])
    todo = np.flatnonzero(finite)
    if len(todo) == 0:
        return out, sample_med

    k1, k2 = (n - 1) // 2, n // 2        # 0-based middle order statistics
    if pad is None:
        pad = _window_pad(n)
    L = max(0, k1 - pad)
    U = min(n, k2 + pad + 1)

    # tie order is irrelevant for the selected *values* (equal values in a
    # tied run), so the faster default introsort is exact here
    ORD = np.argsort(block[todo], axis=1)
    S = np.take_along_axis(block[todo], ORD, axis=1)
    sample_med[todo] = (S[:, k1] if k1 == k2
                        else (S[:, k1] + S[:, k2]) * 0.5)
    CT = draw.counts_t

    # draws strictly below the window, per (benchmark, row): one GEMM
    # against a 0/1 rank-indicator (exact while counts stay < 2**24)
    if L > 0:
        V = np.zeros((len(todo), n), dtype=np.float32)
        np.put_along_axis(V, ORD[:, :L], 1.0, axis=1)
        n_low = (V @ draw.counts_t_f32).astype(np.int64)
    else:
        n_low = np.zeros((len(todo), n_boot), dtype=np.int64)

    # cumulative counts stay in the narrow counts dtype (a full row sums to
    # exactly n, which fits by construction) — uint16 copies/adds/compares
    # are the hot loop and SIMD ~4x wider than int64
    chunk = max(1, _BATCH_CHUNK_ELEMS // max(1, n_boot * (U - L)))
    for s in range(0, len(todo), chunk):
        sl = slice(s, s + chunk)
        cw = CT[ORD[sl, L:U]]                       # (kc, U-L, n_boot)
        np.cumsum(cw, axis=1, out=cw)               # in-place on the copy
        t1 = (k1 + 1) - n_low[sl]                   # per-row crossing targets
        t2 = (k2 + 1) - n_low[sl]
        ok = (t1 >= 1) & (cw[:, -1, :] >= t2)       # int promotion is exact
        t1c = np.clip(t1, 0, None).astype(CT.dtype)  # clipped rows fail `ok`
        t2c = np.clip(t2, 0, None).astype(CT.dtype)
        # cw is nondecreasing along the window: #entries below the target
        # == index of the first crossing (what argmax over >= would find)
        j1 = L + np.count_nonzero(cw < t1c[:, None, :], axis=1)
        os1 = np.take_along_axis(S[sl], j1, axis=1)  # (kc, n_boot)
        if k2 != k1:
            j2 = L + np.count_nonzero(cw < t2c[:, None, :], axis=1)
            med = (os1 + np.take_along_axis(S[sl], j2, axis=1)) * 0.5
        else:                                       # odd n: single middle
            med = os1
        for bi in np.flatnonzero(~ok.all(axis=1)):
            rows = ~ok[bi]
            med[bi, rows] = np.median(
                block[todo[s + bi]][idx[rows]], axis=1)
        out[todo[sl]] = med
    return out, sample_med


def bootstrap_median_ci_batch(arrays: Sequence[np.ndarray], *,
                              confidence: float = DEFAULT_CONFIDENCE,
                              n_boot: int = DEFAULT_BOOTSTRAP,
                              seed: int = 0,
                              backend: str = "numpy",
                              robust: str = "none",
                              robust_k: float = DEFAULT_ROBUST_K,
                              device="cuda") -> tuple:
    """Vectorized `bootstrap_median_ci` over many (possibly ragged) arrays.

    Returns (med, lo, hi) float64 arrays aligned with `arrays`; empty
    inputs yield NaN entries.  The default NumPy backend is bit-for-bit
    equal to calling the scalar function per array with the same
    (confidence, n_boot, seed, robust); ``backend="torch"`` runs the same
    resamples through PyTorch on ``device`` (kernels/stats_boot.py) and
    agrees to float tolerance.  The robust
    fencing is applied per array *before* the length-grouping, so a
    trimmed array simply joins the block of its trimmed length and the
    scalar/batched parity carries over unchanged."""
    if robust != "none":
        arrays = [_robust_view(np.asarray(a, dtype=np.float64), robust,
                               robust_k) for a in arrays]
    if backend == "torch":
        from repro_torch.kernels.stats_boot import \
            bootstrap_median_ci_batch_torch
        return bootstrap_median_ci_batch_torch(
            arrays, confidence=confidence, n_boot=n_boot, seed=seed,
            device=device)
    if backend != "numpy":
        raise ValueError(f"unknown stats backend {backend!r}")
    k = len(arrays)
    med = np.full(k, np.nan)
    lo = np.full(k, np.nan)
    hi = np.full(k, np.nan)
    alpha = (1.0 - confidence) / 2.0

    by_len: Dict[int, list] = {}
    for i, a in enumerate(arrays):
        a = np.asarray(a, dtype=np.float64)
        if len(a):
            by_len.setdefault(len(a), []).append((i, a))
    lo_i, hi_i = _ci_order_stats(n_boot, alpha)
    for n, items in by_len.items():
        pos = np.array([i for i, _ in items])
        block = np.stack([a for _, a in items])
        draw = _boot_draw(n, n_boot, seed)
        boots, sample_med = _window_medians(block, draw)
        nan_rows = np.isnan(boots).any(axis=1)
        boots.partition((lo_i, hi_i), axis=1)
        med[pos] = sample_med
        lo[pos] = boots[:, lo_i]
        hi[pos] = boots[:, hi_i]
        if nan_rows.any():
            # NaN medians (NaN diffs): defer to np.quantile's NaN
            # semantics, like the scalar path (order-independent, so
            # running it after the in-place partition is fine)
            lo[pos[nan_rows]] = np.quantile(
                boots[nan_rows], alpha, axis=1, method="lower")
            hi[pos[nan_rows]] = np.quantile(
                boots[nan_rows], 1.0 - alpha, axis=1, method="higher")
    return med, lo, hi


def detect_changes_batch(items: Iterable[tuple], *,
                         confidence: float = DEFAULT_CONFIDENCE,
                         n_boot: int = DEFAULT_BOOTSTRAP, seed: int = 0,
                         min_results: int = 10,
                         backend: str = "numpy", robust: str = "none",
                         robust_k: float = DEFAULT_ROBUST_K, device="cuda"
                         ) -> Dict[str, "ChangeResult"]:
    """Vectorized `detect_change` over a whole suite.

    `items` yields ``(benchmark, v1, v2)`` triples; the returned dict (in
    input order, below-`min_results` benchmarks omitted) is bit-for-bit
    what a per-benchmark `detect_change` loop would produce (NumPy
    backend; ``backend="torch"`` agrees to float tolerance)."""
    names: list = []
    lens: list = []
    diffs: list = []
    for name, v1, v2 in items:
        v1, v2 = np.asarray(v1), np.asarray(v2)
        n = min(len(v1), len(v2))
        if n == 0 or n < min_results:
            continue
        names.append(name)
        lens.append(n)
        diffs.append(relative_diffs(v1[:n], v2[:n]))
    med, lo, hi = bootstrap_median_ci_batch(diffs, confidence=confidence,
                                            n_boot=n_boot, seed=seed,
                                            backend=backend, robust=robust,
                                            robust_k=robust_k, device=device)
    out: Dict[str, ChangeResult] = {}
    for i, name in enumerate(names):
        m, l, h = float(med[i]), float(lo[i]), float(hi[i])
        changed = l > 0 or h < 0
        direction = 0 if not changed else (1 if m > 0 else -1)
        out[name] = ChangeResult(benchmark=name, n_pairs=lens[i],
                                 median_diff_pct=m, ci_low=l, ci_high=h,
                                 changed=changed, direction=direction)
    return out


# ------------------------------------------------------------------ paper §6.1
def agree(a: ChangeResult, b: ChangeResult) -> bool:
    """Two experiments agree iff both detect a change in the same direction
    or both detect no change."""
    if a.changed != b.changed:
        return False
    return (not a.changed) or (a.direction == b.direction)


def one_sided_coverage(a: ChangeResult, b: ChangeResult) -> bool:
    """a's median inside b's CI."""
    return b.ci_low <= a.median_diff_pct <= b.ci_high


def two_sided_coverage(a: ChangeResult, b: ChangeResult) -> bool:
    return one_sided_coverage(a, b) and one_sided_coverage(b, a)


def cis_overlap(a: ChangeResult, b: ChangeResult) -> bool:
    return a.ci_low <= b.ci_high and b.ci_low <= a.ci_high


@dataclass
class ExperimentComparison:
    n_common: int
    agreement: float                    # fraction agreeing
    disagreements: list                 # benchmark names
    opposite_direction: list            # both changed, different sign
    one_sided_a_in_b: float
    one_sided_b_in_a: float
    two_sided: float
    possible_changes: list              # (name, max |median|) on disagreement


def compare_experiments(res_a: dict, res_b: dict) -> ExperimentComparison:
    """res_*: {benchmark: ChangeResult}; only common benchmarks compared
    (paper §6.2.2: 'after removing microbenchmarks for which only one
    experiment contains results')."""
    common = sorted(set(res_a) & set(res_b))
    if not common:
        return ExperimentComparison(0, float("nan"), [], [], float("nan"),
                                    float("nan"), float("nan"), [])
    agrees, dis, opp, osa, osb, ts, poss = 0, [], [], 0, 0, 0, []
    changed_pairs = 0
    for name in common:
        a, b = res_a[name], res_b[name]
        if agree(a, b):
            agrees += 1
        else:
            dis.append(name)
            poss.append((name, max(abs(a.median_diff_pct), abs(b.median_diff_pct))))
            if a.changed and b.changed and a.direction != b.direction:
                opp.append(name)
        if a.changed and b.changed:
            changed_pairs += 1
            osa += one_sided_coverage(a, b)
            osb += one_sided_coverage(b, a)
            ts += two_sided_coverage(a, b)
    cp = max(changed_pairs, 1)
    return ExperimentComparison(
        n_common=len(common), agreement=agrees / len(common),
        disagreements=dis, opposite_direction=opp,
        one_sided_a_in_b=osa / cp, one_sided_b_in_a=osb / cp,
        two_sided=ts / cp, possible_changes=poss)


def detection_set_delta(res_a: dict, res_b: dict) -> tuple:
    """Benchmarks detected as changed in one experiment but not the other:
    returns (only_in_a, only_in_b), sorted.  The adaptive-vs-fixed
    comparison uses |only_a| + |only_b| as its accuracy distance."""
    det_a = {n for n, c in res_a.items() if c.changed}
    det_b = {n for n, c in res_b.items() if c.changed}
    return sorted(det_a - det_b), sorted(det_b - det_a)


def repeats_for_ci_parity(diffs: np.ndarray, target_ci_size: float, *,
                          steps: Sequence[int], confidence=DEFAULT_CONFIDENCE,
                          n_boot=DEFAULT_BOOTSTRAP, seed=0) -> Optional[int]:
    """Paper §6.2.7: smallest prefix length in `steps` whose bootstrap CI of
    the median is <= target_ci_size.  None if never reached."""
    for n in steps:
        if n > len(diffs):
            break
        _, lo, hi = bootstrap_median_ci(diffs[:n], confidence=confidence,
                                        n_boot=n_boot, seed=seed)
        if hi - lo <= target_ci_size:
            return n
    return None
