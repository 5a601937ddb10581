"""Batched median bootstrap on the CUDA card (the statistics engine's
accelerator backend).

The torch twin of the JAX package's ``kernels/stats_boot.py``.  The NumPy
path (core/stats.py) stays the default and the bit-exact reference; this
module runs the same batched analysis on the card that runs the
workloads: per length class, gather every resample, take each resample's
median, sort the bootstrap medians and read the conservative outward
quantiles as order statistics.

Both backends bootstrap the *same* resamples: the index matrix is the
cached ``(n_boot, n)`` one of ``stats._boot_draw``.  The arithmetic is
float32, as XLA computes it with x64 off, so results agree with the NumPy
path to float tolerance, not bit for bit.  Two details keep the twin
equal to the JAX one:

* the median of an even-length row is the mean of its two middle
  elements (``jnp.median``), not the lower one (``torch.median``), so
  medians come from a sort along n;
* a row with a NaN or an inf goes to the scalar NumPy path, whose NaN
  semantics a sort would lose.

The ``(k, n_boot, n)`` gather is taken in chunks of rows that stay under
``_GATHER_BYTES``.  There is no CPU fallback: ``device="cuda"`` without a
card raises; ``device="cpu"`` runs the same ops on the host (the tests do).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# byte budget of one chunk's float32 gather; the sort along n holds about
# three times as much (values and int64 indices) while it runs
_GATHER_BYTES = 64 << 20


def _middle_mean(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis as ``jnp.median`` takes it: the mean of
    elements (n-1)//2 and n//2 of the sorted row."""
    n = x.shape[-1]
    s = x.sort(dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _block_ci(block: torch.Tensor, idx: torch.Tensor, lo_idx: int,
              hi_idx: int) -> tuple:
    """(k, n) same-length block + (n_boot, n) index matrix -> (med, lo,
    hi), each (k,), gathering at most ``_GATHER_BYTES`` at a time."""
    k, n = block.shape
    n_boot = idx.shape[0]
    rows = max(1, _GATHER_BYTES // (n_boot * n * block.element_size()))
    lo, hi = [], []
    for s in range(0, k, rows):
        boots = _middle_mean(block[s:s + rows][:, idx])   # (c, n_boot)
        boots = boots.sort(dim=1).values
        lo.append(boots[:, lo_idx])
        hi.append(boots[:, hi_idx])
    return _middle_mean(block), torch.cat(lo), torch.cat(hi)


def bootstrap_median_ci_batch_torch(arrays: Sequence[np.ndarray], *,
                                    confidence: float = 0.99,
                                    n_boot: int = 1000, seed: int = 0,
                                    device="cuda") -> tuple:
    """Accelerator twin of `stats.bootstrap_median_ci_batch`.

    Same grouping by length and the same cached index matrices; returns
    (med, lo, hi) NumPy float64 arrays aligned with `arrays` (NaN for
    empty inputs)."""
    from repro_torch.core.stats import _boot_draw, bootstrap_median_ci
    from repro_torch.models.lm import resolve_device
    dev = resolve_device(device)

    k = len(arrays)
    med = np.full(k, np.nan)
    lo = np.full(k, np.nan)
    hi = np.full(k, np.nan)
    alpha = (1.0 - confidence) / 2.0
    lo_idx = int(np.floor(alpha * (n_boot - 1)))
    hi_idx = int(np.ceil((1.0 - alpha) * (n_boot - 1)))

    by_len: dict = {}
    for i, a in enumerate(arrays):
        a = np.asarray(a, dtype=np.float64)
        if not len(a):
            continue
        if not np.isfinite(a).all():
            med[i], lo[i], hi[i] = bootstrap_median_ci(
                a, confidence=confidence, n_boot=n_boot, seed=seed)
            continue
        by_len.setdefault(len(a), []).append((i, a))
    for n, items in by_len.items():
        pos = np.array([i for i, _ in items])
        block = torch.tensor(np.stack([a for _, a in items]),
                             dtype=torch.float32, device=dev)
        idx = torch.tensor(_boot_draw(n, n_boot, seed).idx, device=dev)
        m, l, h = _block_ci(block, idx, lo_idx, hi_idx)
        med[pos] = m.cpu().numpy()
        lo[pos] = l.cpu().numpy()
        hi[pos] = h.cpu().numpy()
    return med, lo, hi
