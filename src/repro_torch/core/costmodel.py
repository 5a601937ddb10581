"""Cost/time models (paper §6: $1.18 FaaS runs vs $1.14 VM baseline, etc.).

FaaS pricing follows AWS Lambda ARM ($/GB-s + $/request); the VM baseline
follows the paper's original-dataset setup (hours of on-demand instances).
A TPU-v5e fleet model prices the same tradeoff for the JAX substrate, so
EXPERIMENTS.md can report the paper's parallelism/cost/wall-time curve on
both the paper's platform and ours.
"""
from __future__ import annotations

from dataclasses import dataclass

# AWS Lambda (ARM, us-east-1, 2024): $0.0000133334 per GB-second + $0.20/1M req
LAMBDA_GB_SECOND = 0.0000133334
LAMBDA_PER_REQUEST = 0.20 / 1_000_000
# Google Cloud Functions gen1: GB-s and GHz-s priced separately, 100 ms
# rounding, $0.40/1M invocations
GCF_GB_SECOND = 0.0000025
GCF_GHZ_SECOND = 0.0000100
GCF_PER_REQUEST = 0.40 / 1_000_000
# Azure Functions consumption plan: $0.000016/GB-s + $0.20/1M, 100 ms minimum
AZURE_GB_SECOND = 0.000016
AZURE_PER_REQUEST = 0.20 / 1_000_000
# paper's VM baseline: m5.large-class on-demand
VM_PER_HOUR = 0.096
# TPU v5e on-demand per chip-hour (public list price ballpark)
TPU_V5E_CHIP_HOUR = 1.20


@dataclass(frozen=True)
class FaaSCost:
    total_gb_seconds: float
    requests: int

    @property
    def dollars(self) -> float:
        return (self.total_gb_seconds * LAMBDA_GB_SECOND
                + self.requests * LAMBDA_PER_REQUEST)


def faas_cost(billed_seconds_per_call, memory_mb: float) -> FaaSCost:
    """billed_seconds_per_call: iterable of per-invocation billed durations."""
    total = float(sum(billed_seconds_per_call))
    return FaaSCost(total_gb_seconds=total * memory_mb / 1024.0,
                    requests=len(list(billed_seconds_per_call))
                    if hasattr(billed_seconds_per_call, "__len__") else 0)


def vm_cost(wall_seconds: float, n_vms: int = 1,
            per_hour: float = VM_PER_HOUR) -> float:
    return wall_seconds / 3600.0 * per_hour * n_vms


def tpu_fleet_cost(wall_seconds: float, n_chips: int,
                   per_chip_hour: float = TPU_V5E_CHIP_HOUR) -> float:
    return wall_seconds / 3600.0 * per_chip_hour * n_chips
