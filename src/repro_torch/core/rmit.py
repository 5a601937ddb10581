"""Randomized Multiple Interleaved Trials (RMIT, paper §2/§4) scheduling.

Builds the randomized invocation plan for a benchmark suite: every
microbenchmark is invoked ``n_calls`` times; each invocation runs
``repeats_per_call`` duet pairs; the order of invocations across the suite
is shuffled so the platform's opaque call->instance assignment randomizes
instance/order effects; within a call the v1/v2 execution order of each
duet pair is randomized as well.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass(frozen=True)
class Invocation:
    """One FaaS function call: run `repeats` duet pairs of one benchmark."""
    benchmark: str
    call_index: int                 # which of the n_calls for this benchmark
    repeats: int                    # duet pairs inside this call
    version_order: tuple            # per-repeat: ("v1","v2") or ("v2","v1")
    timeout_s: float = 20.0         # per-microbenchmark timeout (paper §6.1)
    job_id: str = ""                # service job tag ("" = standalone run)


@dataclass(frozen=True)
class SuitePlan:
    invocations: tuple
    n_calls: int
    repeats_per_call: int

    @property
    def total_results_per_benchmark(self) -> int:
        return self.n_calls * self.repeats_per_call


_V12 = ("v1", "v2")
_V21 = ("v2", "v1")


def _duet_order(rng: random.Random) -> tuple:
    """One randomized duet order, consuming the RNG stream exactly like
    the historical ``rng.sample(("v1", "v2"), 2)``: CPython's `sample`
    takes the small-population pool path, drawing ``_randbelow(2)`` for
    the first element and ``_randbelow(1)`` for the second (which always
    lands on the remaining element but still consumes bits).  Inlining the
    two draws skips sample's per-call pool/set setup — plan construction
    is a hot path at tens of thousands of invocations per commit stream —
    while replaying seed plans bit-for-bit (property-tested against
    `rng.sample` itself, so a CPython behavior change cannot slip by)."""
    j = rng._randbelow(2)
    rng._randbelow(1)
    return _V12 if j == 0 else _V21


def _make_invocation(rng: random.Random, benchmark: str, call_index: int,
                     repeats_per_call: int, randomize_versions: bool,
                     timeout_s: float) -> Invocation:
    """One call with its per-repeat duet version orders — shared by the
    suite planner and the adaptive top-up generator so both stay
    statistically identical."""
    if randomize_versions:
        order = tuple(_duet_order(rng) for _ in range(repeats_per_call))
    else:
        order = tuple(("v1", "v2") for _ in range(repeats_per_call))
    return Invocation(benchmark=benchmark, call_index=call_index,
                      repeats=repeats_per_call, version_order=order,
                      timeout_s=timeout_s)


def make_plan(benchmarks: Sequence[str], *, n_calls: int = 15,
              repeats_per_call: int = 3, randomize_order: bool = True,
              randomize_versions: bool = True, seed: int = 0,
              timeout_s: float = 20.0) -> SuitePlan:
    rng = random.Random(seed)
    inv: List[Invocation] = []
    for b in benchmarks:
        for c in range(n_calls):
            inv.append(_make_invocation(rng, b, c, repeats_per_call,
                                        randomize_versions, timeout_s))
    if randomize_order:
        rng.shuffle(inv)
    return SuitePlan(invocations=tuple(inv), n_calls=n_calls,
                     repeats_per_call=repeats_per_call)


def tag_plan(plan: SuitePlan, job_id: str) -> SuitePlan:
    """The same plan with every invocation tagged as belonging to `job_id`
    (service multiplexing: one engine run interleaves many jobs, and the
    job tag is how backends and observers route work back to its job).
    Tagging does not touch the RNG, so a tagged plan replays the untagged
    plan's schedule bit-for-bit."""
    from dataclasses import replace
    return SuitePlan(
        invocations=tuple(replace(inv, job_id=job_id)
                          for inv in plan.invocations),
        n_calls=plan.n_calls, repeats_per_call=plan.repeats_per_call)


def extra_invocations(benchmark: str, *, n_calls: int,
                      repeats_per_call: int, start_call_index: int,
                      randomize_versions: bool = True, seed: int = 0,
                      timeout_s: float = 20.0) -> List[Invocation]:
    """Top-up invocations for one benchmark (adaptive budget re-allocation):
    `n_calls` additional calls numbered from `start_call_index`, with fresh
    randomized per-pair version orders.  Deterministic in (seed, benchmark,
    start_call_index), so adaptive runs replay exactly."""
    rng = random.Random(f"{seed}:{benchmark}:{start_call_index}")
    return [_make_invocation(rng, benchmark, c, repeats_per_call,
                             randomize_versions, timeout_s)
            for c in range(start_call_index, start_call_index + n_calls)]
