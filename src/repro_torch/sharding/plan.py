"""Single-device stand-in for ``repro.sharding.plan``.

The port runs on one card, so there is no mesh: the plan only carries the
padded head and vocab widths that ``make_plan`` computes for a model axis
of width 1 (vocab padded to a multiple of 128), and ``act`` is the
identity.  Multi-device placements come with the sharding slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShardingPlan:
    cfg: ModelConfig
    H: int                      # q heads (no padding on a 1-wide model axis)
    K: int                      # kv heads
    V: int                      # vocab padded to a multiple of 128

    def act(self, x, *logical):
        """Sharding constraint by logical axes: nothing to do on one device."""
        return x


def make_plan(cfg: ModelConfig) -> ShardingPlan:
    if cfg.num_heads == 0:                      # attention-free (pure SSM)
        H = K = 0
    else:
        H, K = cfg.num_heads, cfg.num_kv_heads
        if H % K != 0:
            K = _smallest_divisor_geq(H, K)
    return ShardingPlan(cfg=cfg, H=H, K=K, V=_round_up(cfg.vocab_size, 128))


def _smallest_divisor_geq(n: int, k: int) -> int:
    """smallest divisor of n that is >= k (exists: n itself)."""
    for d in range(k, n + 1):
        if n % d == 0:
            return d
    return n
