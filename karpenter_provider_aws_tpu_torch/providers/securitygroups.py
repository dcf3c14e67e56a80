"""Security-group provider: tag/id/name selector discovery, TTL-cached.

Parity: ``pkg/providers/securitygroup/securitygroup.go``.
"""

from __future__ import annotations

from typing import Optional

from ..models.nodeclass import NodeClass
from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock


class SecurityGroupProvider:
    def __init__(self, cloud, clock: Optional[Clock] = None):
        self.cloud = cloud
        self._cache = TTLCache(default_ttl=CacheTTL.DEFAULT, clock=clock)

    def list(self, nodeclass: NodeClass):
        key = ("sgs", nodeclass.name, tuple(nodeclass.security_group_selector))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        groups = [
            g
            for g in self.cloud.describe_security_groups()
            if any(term.matches(g) for term in nodeclass.security_group_selector)
            or not nodeclass.security_group_selector
        ]
        self._cache.set(key, groups)
        return groups

    def reset(self) -> None:
        self._cache.flush()
