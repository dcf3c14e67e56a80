"""Subnet provider: discovery + zonal pick + in-flight IP accounting.

Parity: ``pkg/providers/subnet/subnet.go`` — selector-term discovery
(:75-117), per-zone choice of the subnet with the most available IPs
(:133-176), and in-flight IP pre-deduction with give-back for zones the
fleet didn't choose (:168-234).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..models.nodeclass import NodeClass
from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock


class SubnetProvider:
    def __init__(self, cloud, clock: Optional[Clock] = None):
        from ..utils.clock import RealClock

        self.cloud = cloud
        self.clock = clock or RealClock()
        self._cache = TTLCache(default_ttl=CacheTTL.DEFAULT, clock=clock)
        # subnet id -> expiry timestamps of pre-deducted IPs; entries decay
        # after the inflight TTL (parity: 5m inflight-IP cache, cache.go)
        self._inflight: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    def _prune(self, subnet_id: str) -> list[float]:
        now = self.clock.now()
        entries = [t for t in self._inflight.get(subnet_id, []) if t > now]
        if entries:
            self._inflight[subnet_id] = entries
        else:
            self._inflight.pop(subnet_id, None)
        return entries

    def reset(self) -> None:
        with self._lock:
            self._cache.flush()
            self._inflight.clear()

    def list(self, nodeclass: NodeClass):
        """Subnets matching the nodeclass selector terms."""
        key = ("subnets", nodeclass.name, tuple(nodeclass.subnet_selector))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        subnets = [
            s
            for s in self.cloud.describe_subnets()
            if any(term.matches(s) for term in nodeclass.subnet_selector)
            or not nodeclass.subnet_selector
        ]
        self._cache.set(key, subnets)
        return subnets

    def zonal_subnets_for_launch(self, nodeclass: NodeClass, zones,
                                 subnets=None) -> dict[str, str]:
        """zone -> subnet id, choosing the most-available-IP subnet per zone
        and pre-deducting one IP (given back by ``release_unused``).
        ``subnets`` lets the caller pin one discovery snapshot across every
        decision of a single launch (see associate_public_ip_value)."""
        if subnets is None:
            subnets = self.list(nodeclass)
        with self._lock:
            chosen: dict[str, str] = {}
            for zone in zones:
                best = None
                best_ips = -1
                for s in subnets:
                    if s.zone != zone:
                        continue
                    effective = s.available_ips - len(self._prune(s.id))
                    if effective > best_ips:
                        best, best_ips = s, effective
                if best is not None and best_ips > 0:
                    chosen[zone] = best.id
                    self._inflight.setdefault(best.id, []).append(
                        self.clock.now() + CacheTTL.INFLIGHT_IPS
                    )
            return chosen

    def associate_public_ip_value(self, nodeclass: NodeClass,
                                  subnets=None) -> Optional[bool]:
        """Explicit ``False`` only when EVERY subnet the nodeclass resolves
        is known to not auto-assign public IPs; ``None`` (leave the cloud
        default) when any subnet is public or unknown (parity:
        subnet.go:119-130 AssociatePublicIPAddressValue). Pass the SAME
        ``subnets`` snapshot the launch selected from, or a cache expiry
        between the two reads could pin False onto a public-subnet launch."""
        if subnets is None:
            subnets = self.list(nodeclass)
        if subnets and all(getattr(s, "public", None) is False for s in subnets):
            return False
        return None

    def release_unused(self, chosen: dict[str, str], used_zone: str) -> None:
        """Give back pre-deducted IPs for the zones the launch didn't use."""
        with self._lock:
            for zone, subnet_id in chosen.items():
                if zone != used_zone:
                    entries = self._prune(subnet_id)
                    if entries:
                        entries.pop(0)

    def inflight(self, subnet_id: str) -> int:
        with self._lock:
            return len(self._prune(subnet_id))
