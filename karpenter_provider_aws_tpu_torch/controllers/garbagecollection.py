"""GC controller: reap orphaned cloud instances.

Parity: ``pkg/controllers/nodeclaim/garbagecollection/controller.go:51-104``
— list managed cloud instances; any instance older than 30s with no
NodeClaim carrying its provider-ID is a leak and gets terminated.
"""

from __future__ import annotations

from typing import Optional

from ..cloudprovider.cloudprovider import CloudProvider
from ..state.cluster import Cluster
from ..utils import errors
from ..utils.clock import Clock, RealClock

ORPHAN_AGE_S = 30.0  # garbagecollection/controller.go:61 — 30s grace


class GarbageCollectionController:
    name = "garbagecollection"
    # Adaptive requeue (controller.go:84): 10s for the first 20 successful
    # passes — catching post-startup leaks quickly — then 2m steady-state.
    interval_s = 10.0

    def __init__(self, cluster: Cluster, cloudprovider: CloudProvider, clock: Optional[Clock] = None):
        self.cluster = cluster
        self.cloudprovider = cloudprovider
        self.clock = clock or RealClock()
        self.reaped: list[str] = []
        self._successful_passes = 0

    def reconcile(self) -> None:
        from ..operator import sharding

        claimed = {
            c.status.provider_id
            for c in self.cluster.snapshot_claims()
            if c.status.provider_id
        }
        now = self.clock.now()

        def _orphan_key(inst):
            from ..cloudprovider.cloudprovider import NODEPOOL_TAG

            pool = inst.tags.get(NODEPOOL_TAG, "")
            return (pool, inst.zone) if pool else None

        orphans = [
            inst
            for inst in self.cloudprovider.list_instances()
            if inst.provider_id not in claimed
            and now - inst.launch_time >= ORPHAN_AGE_S
            # sharded: each replica reaps only its partitions' orphans
            # (untagged instances fall to the GLOBAL owner)
            and sharding.owns_key(_orphan_key(inst))
        ]
        if orphans:
            # one batched wire call for the whole reap (parity: 100-way
            # parallel reap over a single LIST, terminate batching 500/call),
            # each id fenced by the lease sanctioning its partition when
            # the sharded control plane is active AND the backend hosts
            # fenced leases (an unfenced backend gets the plain call)
            ids = [i.id for i in orphans]
            cloud = self.cloudprovider.cloud
            fences = {}
            for inst in orphans:
                f = sharding.write_fence(key=_orphan_key(inst))
                if f is not None:
                    fences[inst.id] = tuple(f)
            accepts_fences = False
            if fences:
                import inspect

                try:
                    accepts_fences = "fences" in inspect.signature(
                        cloud.terminate_instances
                    ).parameters
                except (TypeError, ValueError):
                    accepts_fences = False
            rejected: set[str] = set()
            if accepts_fences:
                results = cloud.terminate_instances(ids, fences=fences)
                for iid, res in zip(ids, results or []):
                    if isinstance(res, Exception) and errors.is_stale_fence(res):
                        # deposed mid-pass: the instance stays running for
                        # the partition's new owner to reap — stand down
                        rejected.add(iid)
            else:
                cloud.terminate_instances(ids)
            for inst in orphans:
                if inst.id in rejected:
                    continue
                self.reaped.append(inst.id)
                node = self.cluster.node_by_provider_id(inst.provider_id)
                if node is not None:
                    self.cluster.delete(node)
        # only an error-free pass counts toward backing off (controller.go:84)
        self._successful_passes += 1
        if self._successful_passes > 20:
            self.interval_s = 120.0
