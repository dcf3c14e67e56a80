"""Instance-profile provider: idempotent create/delete from spec.role.

Parity: ``pkg/providers/instanceprofile/instanceprofile.go:42-105``.
"""

from __future__ import annotations

from typing import Optional

from ..models.nodeclass import NodeClass
from ..utils import errors
from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock


class InstanceProfileProvider:
    def __init__(self, cloud, cluster_name: str = "cluster-1", clock: Optional[Clock] = None):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self._cache = TTLCache(default_ttl=CacheTTL.INSTANCE_PROFILE, clock=clock)

    def profile_name(self, nodeclass: NodeClass) -> str:
        return f"{self.cluster_name}-{nodeclass.name}"

    def create(self, nodeclass: NodeClass) -> str:
        """Returns the profile name; explicit spec.instanceProfile wins over
        role-derived creation."""
        if nodeclass.instance_profile:
            return nodeclass.instance_profile
        name = self.profile_name(nodeclass)
        if self._cache.get(name):
            return name
        self.cloud.create_instance_profile(
            name, nodeclass.role, {"cluster": self.cluster_name}
        )
        self._cache.set(name, True)
        return name

    def delete(self, nodeclass: NodeClass) -> None:
        if nodeclass.instance_profile:
            return  # unmanaged
        name = self.profile_name(nodeclass)
        try:
            self.cloud.delete_instance_profile(name)
        except Exception as e:
            if not errors.is_not_found(e):
                raise
        self._cache.delete(name)

    def reset(self) -> None:
        self._cache.flush()
