"""Multi-tenant weighted-fair queue (WFQ) over one virtual-time clock.

Classic weighted fair queueing adapted to benchmark invocations: every
tenant owns a weight (its share of the fleet); each pushed item carries a
*size* (its estimated service time in seconds).  Items are stamped with
virtual start/finish tags

    S = max(V, F_tenant_prev)        F = S + size / weight

and dequeued in ascending finish-tag order; the shared virtual clock V
advances to the finish tag of whatever is dequeued (so late arrivals
start at the served horizon, with no retroactive credit).  The result is
the standard WFQ guarantee set:

  * proportional share — over any busy interval a tenant receives service
    proportional to its weight, independent of how many items it queued;
  * starvation-freedom — an item's finish tag is assigned on push and
    never grows, so only the finite set of items with smaller tags can
    bypass it, no matter how much traffic other tenants add *afterwards*;
  * per-tenant FIFO — a tenant's own items keep their push order.

Deterministic: ties on the finish tag break by push sequence number.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Tuple

_EPS_SIZE = 1e-9        # zero-size items still need a positive tag step


class FairQueue:
    """Weighted-fair queue across tenants sharing one virtual clock."""

    def __init__(self, *, default_weight: float = 1.0,
                 weights: Optional[Dict[str, float]] = None):
        if default_weight <= 0:
            raise ValueError("default_weight must be positive")
        self.default_weight = default_weight
        self._weights: Dict[str, float] = dict(weights or {})
        for t, w in self._weights.items():
            if w <= 0:
                raise ValueError(f"weight for {t!r} must be positive")
        self._vclock = 0.0
        self._last_finish: Dict[str, float] = {}
        self._heap: List[Tuple[float, int, str, Any]] = []  # (F, seq, t, it)
        self._seq = 0
        self._queued_per_tenant: Dict[str, int] = {}

    # ------------------------------------------------------------- weights
    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def set_weight(self, tenant: str, weight: float) -> None:
        """Applies to items pushed from now on (tags are assigned at
        push, so already-queued items keep their schedule)."""
        if weight <= 0:
            raise ValueError("weight must be positive")
        self._weights[tenant] = weight

    # -------------------------------------------------------------- queue
    def push(self, tenant: str, item: Any, size: float = 1.0, *,
             weight_scale: float = 1.0) -> float:
        """Enqueue `item` for `tenant`; returns its virtual finish tag.
        `weight_scale` is a per-item priority: >1 shrinks the item's
        virtual size (a high-priority job inside the tenant's share)."""
        w = self.weight(tenant) * weight_scale
        start = max(self._vclock, self._last_finish.get(tenant, 0.0))
        finish = start + max(size, _EPS_SIZE) / w
        self._last_finish[tenant] = finish
        heapq.heappush(self._heap, (finish, self._seq, tenant, item))
        self._seq += 1
        self._queued_per_tenant[tenant] = \
            self._queued_per_tenant.get(tenant, 0) + 1
        return finish

    def pop(self) -> Tuple[str, Any]:
        """Dequeue the item with the smallest finish tag as (tenant, item)."""
        if not self._heap:
            raise IndexError("pop from empty FairQueue")
        finish, _, tenant, item = heapq.heappop(self._heap)
        # V advances to the dequeued item's *finish* tag: with tags
        # assigned at push this keeps V non-decreasing and ensures a
        # newly arriving tenant starts at the current service horizon
        # instead of catching up from 0 (it cannot monopolize the fleet
        # with retroactive credit).
        self._vclock = max(self._vclock, finish)
        self._queued_per_tenant[tenant] -= 1
        return tenant, item

    def drain(self) -> List[Tuple[str, Any]]:
        """Pop everything: the complete weighted-fair dispatch order."""
        out = []
        while self._heap:
            out.append(self.pop())
        return out

    def queued(self, tenant: str) -> int:
        return self._queued_per_tenant.get(tenant, 0)

    def tenants(self) -> List[str]:
        return sorted(t for t, n in self._queued_per_tenant.items() if n > 0)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
