"""Quickstart: ElastiBench in 60 seconds.

Duet-benchmark two implementations of the same layer (naive vs chunked
attention) through the elastic controller, then run the bootstrap analysis —
the paper's pipeline end to end on real PyTorch timings.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's twin of the JAX package's ``examples/quickstart.py``.  Both
versions run eagerly on ``--device``, the CUDA card unless ``--device cpu``
is given.
"""
import argparse

import torch

from repro_torch.core import rmit
from repro_torch.core.controller import ControllerConfig, ElasticController
from repro_torch.core.duet import DuetRunnable
from repro_torch.core.results import analyze
from repro_torch.core.timing import make_timed
from repro_torch.models.attention import attention_chunked, attention_dot
from repro_torch.models.lm import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, 256, 4, 64), generator=g, device=device)
               for _ in range(3))

    # v1 = naive attention, v2 = online-softmax chunked attention
    v1 = make_timed(lambda: attention_dot(q, k, v, causal=True))
    v2 = make_timed(lambda: attention_chunked(q, k, v, causal=True, chunk=64))
    duet = DuetRunnable("attention_dot_vs_chunked", v1, v2)

    # RMIT plan: 15 calls x 1 duet pair, randomized order (paper §4)
    plan = rmit.make_plan([duet.name], n_calls=15, repeats_per_call=1, seed=0)
    controller = ElasticController(
        {duet.name: duet},
        ControllerConfig(max_parallelism=4, benchmark_timeout_s=30.0))
    report = controller.run_suite(plan)

    # bootstrap CI of the median relative difference (paper §2)
    for name, res in analyze(report.pairs).items():
        verdict = ("PERFORMANCE CHANGE" if res.changed else "no change")
        print(f"{name}: median diff {res.median_diff_pct:+.1f}% "
              f"(99% CI [{res.ci_low:+.1f}%, {res.ci_high:+.1f}%]) "
              f"over {res.n_pairs} duet pairs -> {verdict}")
    print(f"wall {report.wall_seconds:.1f}s, "
          f"{report.invocations_done} invocations, "
          f"{report.retries} retries, {report.hedged} hedged")


if __name__ == "__main__":
    main()
