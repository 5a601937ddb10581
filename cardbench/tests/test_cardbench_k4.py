"""``k4.roofline`` on a made-up run: the yardstick's bound of the program's
``k4`` spans over the device time of the kernels named for K4."""
from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.tests.tiny import BENCH
from cardbench.trace import TraceData
from repro_torch.core.scope import Span

CARD = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}


def _k4(sid, rows, channels, width=4, itemsize=2):
    return Span("k4", sid, 0, 0, 1, dict(rows=rows, channels=channels, width=width,
                                         itemsize=itemsize))


def _run(ops):
    return SimpleNamespace(card=CARD, trace=TraceData(ops=ops))


def test_k4_roofline_reads_the_bound_over_the_kernels_time(monkeypatch):
    from repro_torch.core import scope
    read = harness.reader(BENCH.parent, "k4.roofline")
    spans = [_k4(1, 131_072, 4_352), _k4(2, 65_536, 8_448),
             Span("conv", 3, 0, 0, 1, {"impl": "k4"})]
    nbytes = sum((2 * rows + 5) * ch * 2 for rows, ch in ((131_072, 4_352), (65_536, 8_448)))
    bound = nbytes / CARD["bytes_per_s"]
    monkeypatch.setattr(scope, "spans", lambda: spans)
    ops = {"void causal_conv_silu_kernel<4>(Parts, long long)": 1.5 * bound,
           "void (anonymous namespace)::causal_conv_silu_kernel<3>(...)": 0.5 * bound,
           "nvjet_hsh_128x256": 9.0}
    assert read(_run(ops)) == pytest.approx(50.0)


def test_k4_roofline_reads_none_without_spans_or_kernels(monkeypatch):
    from repro_torch.core import scope
    read = harness.reader(BENCH.parent, "k4.roofline")
    ops = {"void causal_conv_silu_kernel<4>(Parts, long long)": 1e-3}
    monkeypatch.setattr(scope, "spans", lambda: [Span("conv", 1, 0, 0, 1, {"impl": "plain"})])
    assert read(_run(ops)) is None                       # no k4 span (the parent's program)
    monkeypatch.setattr(scope, "spans", lambda: [_k4(1, 1024, 160)])
    assert read(_run({"nvjet_hsh_128x256": 1e-3})) is None   # no K4 kernel traced
    assert read(SimpleNamespace(card=CARD, trace=None)) is None
    monkeypatch.delattr(scope, "spans")
    assert read(_run(ops)) is None
