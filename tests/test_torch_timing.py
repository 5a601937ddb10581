"""Calibration of repro_torch.core.timing against repro.core.timing.

Both read ``time.perf_counter``; a fake clock advanced by the timed
function makes every call's cost exact, and the two harnesses must choose
the same inner-repeat count, per-call time and cold flag.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import timing as jax_timing  # noqa: E402
from repro_torch.core import timing  # noqa: E402


class FakeClock:
    def __init__(self, costs):
        self.now = 0.0
        self.costs = iter(costs)
        self.calls = 0

    def perf_counter(self):
        return self.now

    def fn(self):
        self.now += next(self.costs)
        self.calls += 1


def _run(module, monkeypatch, costs, **kw):
    clock = FakeClock(costs)
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)
    return module.time_fn(clock.fn, **kw), clock.calls


@pytest.mark.parametrize("costs,kw,inner,cold", [
    # 4 ms a call: 1 call, then the estimate (4 after float rounding), then
    # doubling to 8 calls (32 ms >= 20 ms); a 0.5 s first call is cold
    (itertools.chain([0.5], itertools.repeat(0.004)), {}, 8, True),
    # 15 ms a call: the estimate (1) is below doubling, so inner doubles to 2
    (itertools.chain([0.01], itertools.repeat(0.015)), {}, 2, False),
    # 1 us a call: capped at max_inner though 8 us < min_measure_s
    (itertools.chain([1e-6], itertools.repeat(1e-6)), dict(max_inner=8), 8, False),
])
def test_calibration_matches_jax_harness(monkeypatch, costs, kw, inner, cold):
    costs = list(itertools.islice(costs, 64))
    t, calls = _run(timing, monkeypatch, costs, **kw)
    t_ref, calls_ref = _run(jax_timing, monkeypatch, costs, **kw)
    assert t.inner_repeats == t_ref.inner_repeats == inner
    assert t.cold == t_ref.cold == cold
    assert t.seconds_per_call == pytest.approx(t_ref.seconds_per_call)
    assert t.compile_seconds == pytest.approx(t_ref.compile_seconds) == costs[0]
    assert calls == calls_ref


def test_block_is_a_no_op_for_cpu_tensors():
    x = torch.ones(3)
    assert timing.block(x) is x
    assert timing.block({"a": x})["a"] is x


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA card, so that ``block``'s
    walk can be checked without one."""
    index = 0

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", self.index)


def _on_card(index=0):
    t = torch.ones(2).as_subclass(_OnCard)
    t.index = index
    return t


@pytest.mark.parametrize("make,want", [
    (lambda t, u: t, {0}),
    (lambda t, u: (t, u), {0, 1}),
    (lambda t, u: ((t,), u), {0, 1}),
    (lambda t, u: {"a": (t,)}, {0}),
    (lambda t, u: ({"y": t},), {0}),
    (lambda t, u: [torch.ones(1), {"k": [u, (t, t)]}], {0, 1}),
], ids=["tensor", "flat", "nested-tuple", "dict-of-tuple", "tuple-of-dict",
        "mixed"])
def test_block_synchronises_every_card_in_a_nest(monkeypatch, make, want):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    out = make(_on_card(0), _on_card(1))
    assert timing.block(out) is out
    assert sorted(d.index for d in synced) == sorted(want)
    assert all(d.type == "cuda" for d in synced)


def test_make_timed_returns_seconds_per_call():
    run = timing.make_timed(torch.add, torch.ones(4), 1)
    s = run()
    assert 0 < s < 1
