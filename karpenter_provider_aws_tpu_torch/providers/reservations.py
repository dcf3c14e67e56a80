"""Capacity-reservation discovery provider.

Same altitude as SubnetProvider/SecurityGroupProvider (parity:
``pkg/providers/`` adapters — each selector-resolving cloud lookup lives in
a cached provider, not in a controller): owns the describe call, a TTL
cache, and selector matching, so the status controller stays a pure
spec->status reconciler.
"""

from __future__ import annotations

from typing import Optional

from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock


class ReservationProvider:
    def __init__(self, cloud, clock: Optional[Clock] = None):
        from ..utils.clock import RealClock

        self.cloud = cloud
        self.clock = clock or RealClock()
        self._cache = TTLCache(default_ttl=CacheTTL.DEFAULT, clock=clock)

    def reset(self) -> None:
        self._cache.flush()

    def list_all(self):
        """Every capacity reservation visible to the account (one describe
        serves all nodeclasses within the TTL window)."""
        hit = self._cache.get("all")
        if hit is not None:
            return hit
        out = list(self.cloud.describe_capacity_reservations())
        self._cache.set("all", out)
        return out

    def list(self, nodeclass):
        """Reservations matching the nodeclass selector terms."""
        if not nodeclass.capacity_reservation_selector:
            return []
        return [
            r
            for r in self.list_all()
            if any(term.matches(r) for term in nodeclass.capacity_reservation_selector)
        ]
