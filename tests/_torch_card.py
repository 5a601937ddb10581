"""Helpers of the tests that run the port on a CUDA card (``-m cuda``).

The card tests import this module, so it imports no jax and nothing of the
JAX package: a machine with a card and no jax runs them.  The tests
directory is on the path of every test module.
"""
import pytest


def skip_without_card(what):
    """Skip the calling test unless a CUDA card is present, before it builds
    anything; ``what`` says why it needs one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA card: {what}")


def agreement(a, b, tol):
    """(max |a - b|, the largest share of the tolerance atol = rtol = tol
    that an entry uses, entries out of tolerance).  The share tells output
    rounding apart from a real error: at |b| in [8, 16) one bf16 step is
    0.0625 yet only ~0.1 of the tolerance."""
    err = (a - b).abs()
    allowed = tol + tol * b.abs()
    return float(err.max()), float((err / allowed).max()), int((err > allowed).sum())


def row_share(a, b, tol):
    """The largest ||a_r - b_r|| / (tol ||b_r||) over the rows r of the last
    dim: the output's own scale in each row.  At random N(0, 1) inputs an
    attention row over ~1500 keys averages to |o| ~ 0.03, as small as the
    bf16 atol, so only a bound relative to the row sees a kernel that is a
    few percent off or drops a key tile there."""
    err = (a - b).norm(dim=-1)
    return float((err / (tol * b.norm(dim=-1)).clamp_min(1e-30)).max())


def assert_rows_within(got, ref, tol):
    """Each row of ``got``'s last dim within ``tol`` of the norm of
    ``ref``'s row (``row_share``)."""
    share = row_share(got.float(), ref.float(), tol)
    assert share <= 1.0, share


class Launches:
    """Every kernel's launches from when the object is made, read from its
    public wrapper's counters: ``.total()`` by kernel, ``.by_variant()`` by
    kernel and variant (none for K4, which has one)."""

    def __init__(self):
        from repro_torch.kernels.causal_conv import causal_conv_silu
        from repro_torch.kernels.decode_attention import decode_attention
        from repro_torch.kernels.flash_attention import flash_attention_hmajor
        from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
        self.wrappers = {"K1": flash_attention_hmajor, "K2": ssd_scan_hmajor,
                         "K3": decode_attention, "K4": causal_conv_silu}
        self.start = self._read()

    def _read(self):
        return {k: (w.launches, dict(getattr(w, "launches_by_variant", {})))
                for k, w in self.wrappers.items()}

    def total(self):
        return {k: w.launches - self.start[k][0] for k, w in self.wrappers.items()}

    def by_variant(self):
        return {k: {v: n - self.start[k][1][v]
                    for v, n in getattr(w, "launches_by_variant", {}).items()}
                for k, w in self.wrappers.items()}
